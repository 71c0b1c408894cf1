"""The port's serving subcommands as a user runs them —
``python -m mfx_torch.cli recommend|similar|export --device cpu`` in a
subprocess over a checkpoint the port wrote — against ``mfx.cli`` on the
same checkpoint: the same JSON lines (items equal modulo near-ties,
scores within 1e-5), the same exported model."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mfx.cli
from mfx.models.mf import MFModel as JMFModel
from mfx_torch.convert import model_from_numpy
from mfx_torch.train.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
U, I, RANK = 40, 900, 8


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    rng = np.random.default_rng(8)
    model = model_from_numpy({
        "P": rng.normal(0, 0.5, (U, RANK)), "Q": rng.normal(0, 0.5, (I, RANK)),
        "bu": rng.normal(0, 0.2, U), "bi": rng.normal(0, 0.2, I),
        "mu": np.float32(3.5),
    }, device="cpu")
    d = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(d, 4, model, seed=1)
    return d


def _port(args, cwd):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-m", "mfx_torch.cli", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return [json.loads(line) for line in res.stdout.splitlines()]


def _reference(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mfx.cli.main(args) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("cmd", [
    ["recommend", "--users", "0,7,39", "--k", "5"],
    ["recommend", "--users", "0,7,39", "--k", "5", "--fused", "--tile",
     "128"],
    ["similar", "--items", "0,11,899", "--k", "4"],
    ["similar", "--items", "0,11,899", "--k", "1", "--fused"],
])
def test_subcommands_print_the_references_json(ckpt, tmp_path, cmd):
    args = [cmd[0], "--checkpoint", str(ckpt), *cmd[1:]]
    got = _port([*args, "--device", "cpu"], tmp_path)
    want = _reference(args)
    items, scores = (("items", "scores") if cmd[0] == "recommend"
                     else ("similar", "cosine"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_allclose(g[scores], w[scores], rtol=1e-5,
                                   atol=1e-5)
        assert np.mean(np.asarray(g[items]) != np.asarray(w[items])) <= 0.1
        key = "user" if cmd[0] == "recommend" else "item"
        assert g[key] == w[key]


def test_export_writes_the_references_model(ckpt, tmp_path):
    got = _port(["export", "--checkpoint", str(ckpt), "--out",
                 str(tmp_path / "port.npz")], tmp_path)
    want = _reference(["export", "--checkpoint", str(ckpt), "--out",
                       str(tmp_path / "ref.npz")])
    assert got[0] == {**want[0], "out": str(tmp_path / "port.npz")}
    a = JMFModel.load_npz(tmp_path / "port.npz", device=False)
    b = JMFModel.load_npz(tmp_path / "ref.npz", device=False)
    for k in ("P", "Q", "bu", "bi", "mu"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)


def test_serve_refuses_mmr(ckpt):
    """serve --mmr is ported (tests/test_torch_rerank.py serves it); a
    relevance weight outside [0, 1] is refused before the server starts,
    with the reference's error."""
    from mfx_torch.cli import main

    with pytest.raises(ValueError, match=r"lam must be in \[0, 1\]"):
        main(["serve", "--checkpoint", str(ckpt), "--mmr", "1.5",
              "--device", "cpu", "--port", "0"])
