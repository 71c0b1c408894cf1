"""``python -m mfx_torch.cli eval`` against ``mfx.cli``'s ``eval`` on one
checkpoint the port wrote, for every ``--split`` (a timestamped dataset in
the loader's cache under ``--root``, so that the time protocols run), each
split with a ranking protocol and the implicit AUC once: the same JSON
keys (``checkpoint_epoch`` and the metrics) and every value within 1e-6.
Also the public façade ``mfx_torch.api``: the reference's names less the
ones not ported yet, each of which raises naming its ROADMAP item, and
the reference's version."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mfx.api
import mfx.cli
from mfx.data import loaders as jloaders
from mfx.data import synthetic as jsyn
from mfx.version import __version__ as j_version
from mfx_torch.convert import model_from_numpy
from mfx_torch.train.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
U, I, RANK = 150, 400, 8
NAME = "synthetic-small"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    coo = jsyn.make_synthetic(U, I, 8000, rank=4, seed=21)
    rng = np.random.default_rng(21)
    ts = rng.integers(0, 1_000_000, coo.n_ratings).astype(np.int64)
    coo = coo.__class__(user=coo.user, item=coo.item, rating=coo.rating,
                        num_users=U, num_items=I, timestamp=ts)
    root = d / "data"
    root.mkdir()
    coo.save_npz(root / f"{NAME}.v{jloaders.GENERATOR_VERSION}.npz")
    model = model_from_numpy({
        "P": rng.normal(0, 0.4, (U, RANK)), "Q": rng.normal(0, 0.4, (I, RANK)),
        "bu": rng.normal(0, 0.2, U), "bi": rng.normal(0, 0.2, I),
        "mu": np.float32(3.4)}, device="cpu")
    save_checkpoint(d / "ck", 7, model, seed=3)
    return d, root


def _port(args, cwd):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-m", "mfx_torch.cli", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()


def _reference(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mfx.cli.main(args) == 0
    return buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("split,extra", [
    ("uniform", ["--ranking-k", "5", "--ranking-protocol", "sampled"]),
    ("uniform", ["--implicit"]),
    ("loo", ["--ranking-k", "10", "--ranking-protocol", "full"]),
    ("time", ["--ranking-k", "5", "--ranking-protocol", "user",
              "--test-frac", "0.2"]),
    ("user-time", ["--ranking-k", "10", "--ranking-protocol", "full"]),
    ("loo-time", ["--ranking-k", "5", "--ranking-protocol", "user"]),
])
def test_eval_prints_the_references_json(setup, split, extra):
    d, root = setup
    args = ["eval", "--checkpoint", str(d / "ck"), "--dataset", NAME,
            "--root", str(root), "--split", split, *extra]
    got, = _port([*args, "--device", "cpu"], d)
    want, = _reference(args)
    assert list(json.loads(got)) == sorted(json.loads(got))  # sort_keys
    got, want = json.loads(got), json.loads(want)
    assert set(got) == set(want) and got["checkpoint_epoch"] == 7
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_api_has_the_references_names():
    from mfx_torch import api
    from mfx_torch.version import __version__

    assert __version__ == j_version == api.__version__
    assert set(api.__all__) == set(mfx.api.__all__) - set(api.NOT_PORTED)
    assert set(api.NOT_PORTED) < set(mfx.api.__all__)
    for name in api.__all__:
        assert getattr(api, name) is not None
    for name, item in api.NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            getattr(api, name)
        assert "Queue 1 item" in item
    with pytest.raises(AttributeError):
        api.no_such_name
