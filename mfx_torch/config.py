"""Config system — SURVEY.md A1.

Frozen dataclasses, one named preset per BASELINE.json config, and simple
``key.subkey=value`` dot-overrides for the CLI. No gin/hydra dependency.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "DataConfig",
    "ModelConfig",
    "SGDConfig",
    "SVDPPConfig",
    "TimeSVDConfig",
    "TimeSVDPPConfig",
    "ALSConfig",
    "NMFConfig",
    "IALSConfig",
    "BPRConfig",
    "ParallelConfig",
    "TrainConfig",
    "PRESETS",
    "preset",
    "apply_overrides",
]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "ml-100k"
    root: str | None = None  # defaults to $MFX_DATA_ROOT
    test_frac: float = 0.1
    seed: int = 0
    # held-out protocol: 'random' — seeded uniform split; 'time' —
    # global chronological cut (train on the past, test on the future);
    # 'user-time' — per-user timeline cut (each user's last fraction of
    # events held out). The time protocols need a dataset whose source
    # files carry timestamps.
    split: str = "random"

    def __post_init__(self):
        if self.split not in ("random", "time", "user-time"):
            raise ValueError(
                "data.split must be 'random', 'time' or 'user-time', "
                f"got {self.split!r}"
            )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    rank: int = 16
    use_bias: bool = False
    init_scale: float | None = None  # None -> 1/sqrt(rank)
    dtype: str = "float32"  # factor-table dtype
    seed: int = 0
    # bias initialization (use_bias=True only):
    # 'zero'     — zeros; SGD learns the biases from scratch
    # 'baseline' — damped per-item/per-user mean residuals (Koren's
    #              baseline predictor: b_i = Σ(r−μ)/(λ+n_i), then
    #              b_u over the b_i-corrected residual) — starts every
    #              epoch-0 prediction at the classic baseline estimate
    bias_init: str = "zero"
    bias_damping: float = 10.0  # the λ above

    def __post_init__(self):
        if self.bias_init not in ("zero", "baseline"):
            raise ValueError(
                "model.bias_init must be 'zero' or 'baseline', got "
                f"{self.bias_init!r}"
            )


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.01
    reg: float = 0.02
    lr_decay: float = 1.0  # per-epoch multiplicative decay
    epochs: int = 20
    batch_size: int = 8192
    # 'fixed'          — permutation batches + segment-sum reduction
    # 'conflict_free'  — greedy matching rounds (no dup user/item per batch)
    # 'blocked'        — DSGD strata driving the blocked one-hot kernel
    partitioner: str = "fixed"
    # 'jnp'            — XLA gather/scatter reference path (K4)
    # 'blocked_jnp'    — block-stratified one-hot MXU path, pure XLA
    # 'pallas'         — fused Pallas TPU kernel (K1)
    kernel: str = "jnp"
    ublock: int = 512  # user rows per block (blocked paths)
    iblock: int = 512  # item rows per block
    tile: int = 256  # ratings per update tile inside a stratum
    # strata denser than this run the dense DSGD fast path (Zipf head);
    # 0 disables; NEGATIVE = 'auto' — the per-stratum dense/sparse
    # boundary comes from the chip-calibrated cost model over the
    # occupancy histogram (mfx/solvers/dense_prep.py
    # auto_dense_threshold; requires dense_span='full').
    # Requires kernel='pallas', rank 64, ublock == iblock.
    dense_chi: float = 0.0
    # item span the dense phase may carve strata from:
    # 'head' — only the first DENSE_HEAD_ITEMS items (one phase on the
    #          VMEM-resident head; works with host or device prep)
    # 'full' — any stratum in the whole item span: strata are grouped by
    #          item-window segments and each group runs its own dense
    #          phase on a VMEM-resident Q segment before the sparse
    #          sweeps (measured +20% at ML-25M shape: half the sparse
    #          tail sits in dense-eligible strata outside the head).
    #          Requires the device planner (single-chip pallas path).
    dense_span: str = "head"
    # windows per dense-phase group for dense_span='full' (0 = auto from
    # the dense VMEM budget: the group's Q segment must fit next to the
    # dense kernel's R pipeline buffers)
    dense_nwd: int = 0
    # per-row trust scaling for duplicate-heavy batches on the jnp paths
    # ('fixed' partitioner): a row appearing d times in a batch gets its
    # summed delta scaled by min(1, dup_trust/d). 0 disables. Guards
    # against hot-row divergence under Zipf skew at large batch sizes.
    dup_trust: float = 0.0
    # MXU input precision for the fused kernel's one-hot gather/scatter
    # matmuls: 'f32' (exact table reads) or 'bf16' (8-bit-mantissa reads/
    # deltas, f32 accumulate — multiple of the f32 MXU rate, SGD-noise-
    # level rounding; factor tables stay f32 either way)
    mxu: str = "f32"
    # fused kernel: batch the user-side one-hot matmuls of each grid
    # step's tpg tiles into one 4x-row matmul pair (gather at step start,
    # scatter at step end). The user side becomes a (tpg*tile)-minibatch
    # with exact segment-sum accumulation; item side stays per-tile.
    # False = the parity-tested per-tile path.
    step_user_batch: bool = False
    # bias update granularity on the fused-kernel path:
    # 'tile'  — per-tile bias gather/scatter inside the kernel (exact
    #           per-occurrence updates; the parity-tested default)
    # 'lane'  — biases ride IN the factor lanes (augmented-vector MF:
    #           P row = [p(rank-2), 1, bu], Q row = [q(rank-2), bi, 1]).
    #           The factor dot carries the biases and the bias lane's SGD
    #           step IS the per-occurrence bias update, so the entire
    #           per-tile bias machinery (measured 32% of the sparse path
    #           at su=1024) disappears for the cost of 2 latent dims and
    #           one static delta mask. Requires kernel='pallas'; runs
    #           single-chip AND in the DSGD ring (the ml25m and
    #           configs[3] presets both use it).
    # 'epoch' — biases frozen per epoch: the planner bakes bu[u]+bi[i]
    #           into the tile stream, the kernel emits residuals, and one
    #           batched trust-scaled bias update applies per epoch —
    #           removes the per-tile bias machinery. Requires
    #           kernel='pallas' + the device planner; single-chip only.
    bias_mode: str = "tile"
    # dense-phase rating stream width: 'int8' grid (round(r*25), ~0.012
    # std error), or 'int4' nibbles (round(r*2) — EXACT for real star-
    # scale ratings, half the HBM stream). 'auto' picks int4 when every
    # rating is exactly on the half-star grid and rank is 64/32
    # (pack 2/4); 'on' forces it; 'off' keeps int8.
    dense_int4: str = "auto"
    # pack>1 lane handling on the fused kernel's tile path:
    # 'roll'   — prediction/deltas stay in the packed 128-lane space via
    #            masked arithmetic + static lane rotations (no select-
    #            merge or lane-concat relayouts; bitwise-identical to
    #            'select' compiled on TPU, ~1 ULP/step in interpret
    #            mode; measured ~2% faster sparse sweeps)
    # 'select' — per-slot select-merge to (tile, rank) and concat back
    #            (the original form; step_user_batch always uses it)
    pack_path: str = "roll"
    # dense-phase data echoing: SGD passes per stratum per epoch on the
    # VMEM-resident R block. The dense phase is HBM-bound on the R
    # stream, so extra in-VMEM batch steps cost only (partly idle) MXU
    # time — more rating updates per byte streamed, faster convergence
    # per epoch (each stratum takes `dense_echo` Jacobi-style steps).
    # Requires bias_mode='lane' (or use_bias=False) when > 1.
    dense_echo: int = 1
    # strata per dense-kernel grid step (dense_span='full' only). The
    # dense phase is fixed-cost-bound per grid step on the bench chip
    # (~10 µs/stratum vs a ~4 µs MXU floor — STATUS.md r4 roofline);
    # batching spg strata into one grid invocation (one R/aux DMA, one
    # pipeline step) amortizes it. The prep pads each (group, user-block)
    # stratum run to a multiple of spg with exact-no-op null strata, so
    # the trajectory is bitwise spg-invariant; the cost is streaming the
    # padding's zero R blocks (reported via dense_info strata_padded).
    # MEASURED on the bench chip (r5): the dense phase standalone
    # improves ~16% at spg=2 but the full epoch does NOT (padding +
    # stream growth offset it) — the preset stays 1. spg>2 at the
    # 1024-block geometry also needs dense_nwd lowered (the R double
    # buffers scale with spg against the 16 MB scoped-VMEM limit;
    # spg=4 compiles at dense_nwd<=4).
    dense_spg: int = 1
    # blocked paths: rebuild the epoch plan every N epochs (0 = plan
    # once and reuse; stratified order already randomizes within strata)
    replan_every: int = 4
    # where per-epoch tile planning runs for kernel='pallas':
    # 'device' — seeded sort+scatter on the accelerator (ms/epoch;
    #            mfx/kernels/plan_device.py)
    # 'host'   — vectorized NumPy / native C++ planner (tens of seconds
    #            per 25M-rating epoch on a throttled host)
    # 'auto'   — device on TPU backends, host otherwise
    plan_device: str = "auto"

    def __post_init__(self):
        # free-string fields: any typo ('bfloat16', 'Device', …) would
        # otherwise silently select a fallback path — the same silent-
        # fallback class the driver's parallel-mode validation rejects
        if self.mxu not in ("f32", "bf16"):
            raise ValueError(
                f"sgd.mxu must be 'f32' or 'bf16', got {self.mxu!r}"
            )
        if self.plan_device not in ("auto", "host", "device"):
            raise ValueError(
                "sgd.plan_device must be 'auto', 'host' or 'device', "
                f"got {self.plan_device!r}"
            )
        if self.kernel not in ("jnp", "blocked_jnp", "pallas"):
            raise ValueError(
                "sgd.kernel must be 'jnp', 'blocked_jnp' or 'pallas', "
                f"got {self.kernel!r}"
            )
        if self.partitioner not in ("fixed", "conflict_free", "blocked"):
            raise ValueError(
                "sgd.partitioner must be 'fixed', 'conflict_free' or "
                f"'blocked', got {self.partitioner!r}"
            )
        if self.dense_int4 not in ("auto", "on", "off"):
            raise ValueError(
                "sgd.dense_int4 must be 'auto', 'on' or 'off', "
                f"got {self.dense_int4!r}"
            )
        if self.pack_path not in ("roll", "select"):
            raise ValueError(
                f"sgd.pack_path must be 'roll' or 'select', got "
                f"{self.pack_path!r}"
            )
        if self.dense_span not in ("head", "full"):
            raise ValueError(
                f"sgd.dense_span must be 'head' or 'full', got "
                f"{self.dense_span!r}"
            )
        if self.dense_chi < 0 and self.dense_span != "full":
            raise ValueError(
                "sgd.dense_chi<0 ('auto': cost-model stratum carving) "
                "needs the full-span dense split; set sgd.dense_span='full'"
            )
        if self.bias_mode not in ("tile", "lane", "epoch"):
            raise ValueError(
                f"sgd.bias_mode must be 'tile', 'lane' or 'epoch', got "
                f"{self.bias_mode!r}"
            )
        if self.bias_mode != "tile" and self.kernel != "pallas":
            raise ValueError(
                f"sgd.bias_mode={self.bias_mode!r} is implemented by the "
                "fused Pallas kernel; set sgd.kernel='pallas'"
            )
        if self.bias_mode != "tile" and self.step_user_batch:
            raise ValueError(
                f"sgd.bias_mode={self.bias_mode!r} and sgd.step_user_batch "
                "are mutually exclusive kernel variants"
            )
        if self.dense_echo < 1:
            raise ValueError(
                f"sgd.dense_echo must be >= 1, got {self.dense_echo}"
            )
        if self.dense_echo > 1 and self.bias_mode == "epoch":
            raise ValueError(
                "sgd.dense_echo > 1 needs per-pass bias semantics: use "
                "bias_mode='lane' (or 'tile', or a bias-free model) — "
                "'epoch' consumes single-pass residual sums"
            )
        if self.dense_spg < 1 or self.dense_spg > 8:
            raise ValueError(
                f"sgd.dense_spg must be in [1, 8], got {self.dense_spg} "
                "(spg R pipeline buffers scale VMEM linearly; 8 is the "
                "16 MB envelope at the 1024-block int4 geometry)"
            )
        if self.dense_spg > 1 and self.dense_span != "full":
            raise ValueError(
                "sgd.dense_spg > 1 requires sgd.dense_span='full' (the "
                "full-span prep pads stratum runs per user block; the "
                "head split has no padding path)"
            )


@dataclasses.dataclass(frozen=True)
class SVDPPConfig:
    """SVD++ (mfx/solvers/svdpp.py): biased MF plus implicit item factors
    y_j with epoch-frozen implicit sums — the canonical quality step
    beyond configs[1]'s biased MF on the same explicit data."""

    lr: float = 0.007
    reg: float = 0.02
    lr_decay: float = 0.95
    epochs: int = 20
    batch_size: int = 8192
    lr_y: float | None = None  # Y-step rate; None -> lr (same decay)
    reg_y: float | None = None  # Y L2 (deg-scaled); None -> reg
    # trust cap on the epoch-batched Y step (the dup_trust analog): item
    # j's residual pull is scaled by min(1, y_trust / c_j) with
    # c_j = sum_{u: j in N(u)} sqrt(deg_u) — hot items would otherwise
    # take a same-snapshot batched step past the stable region. 0 = off.
    y_trust: float = 16.0
    partitioner: str = "fixed"  # 'fixed' | 'conflict_free'
    dup_trust: float = 0.0  # hot-row trust scaling (as SGDConfig)

    def __post_init__(self):
        if self.partitioner not in ("fixed", "conflict_free"):
            raise ValueError(
                "svdpp.partitioner must be 'fixed' or 'conflict_free', "
                f"got {self.partitioner!r}"
            )


@dataclasses.dataclass(frozen=True)
class TimeSVDConfig:
    """Temporal-dynamics MF (mfx/solvers/timesvd.py): Koren's KDD-2009
    bias-level model — time-binned item biases + a learned per-user
    drift coefficient against a smooth deviation curve — on top of
    biased MF. Needs a dataset with timestamps (RatingsCOO.timestamp)."""

    lr: float = 0.007
    reg: float = 0.02
    lr_decay: float = 0.95
    epochs: int = 20
    batch_size: int = 8192
    n_bins: int = 30  # item-bias time bins (equal-count over train)
    beta: float = 0.4  # dev_u(t) = sign(Δ)·|Δ/span|^beta
    lr_t: float | None = None  # bin-bias rate; None -> lr
    reg_t: float | None = None  # bin-bias L2; None -> reg
    lr_alpha: float | None = None  # drift rate; None -> lr
    # drift L2; None -> 10*reg (dev is normalized to |Δ/span|^beta <= ~1,
    # so alpha needs stronger damping than the raw biases — Koren used
    # reg_alpha 25x the bias reg at day-unit dev scale)
    reg_alpha: float | None = None
    partitioner: str = "fixed"  # 'fixed' | 'conflict_free'
    dup_trust: float = 0.0  # hot-key trust scaling (as SGDConfig)
    # 'jnp' — snapshot-minibatch scan (full per-term lr/reg schedule);
    # 'pallas' — the fused blocked kernel with lane-carried temporal
    #            terms (mfx/solvers/timesvd_blocked.py): the TPU-rate
    #            path, ~an order of magnitude faster, with ONE lr/reg
    #            for every term and n_bins <= rank-4
    kernel: str = "jnp"

    def __post_init__(self):
        if self.partitioner not in ("fixed", "conflict_free"):
            raise ValueError(
                "timesvd.partitioner must be 'fixed' or 'conflict_free', "
                f"got {self.partitioner!r}"
            )
        if self.n_bins < 1:
            raise ValueError(f"timesvd.n_bins must be >= 1, got {self.n_bins}")
        if self.kernel not in ("jnp", "pallas"):
            raise ValueError(
                f"timesvd.kernel must be 'jnp' or 'pallas', got "
                f"{self.kernel!r}"
            )


@dataclasses.dataclass(frozen=True)
class TimeSVDPPConfig:
    """timeSVD++ (mfx/solvers/timesvdpp.py): the temporal bias model of
    TimeSVDConfig COMBINED with SVD++'s implicit item factors — the
    Netflix-Prize-era flagship of this family. Needs timestamps."""

    lr: float = 0.007
    reg: float = 0.02
    lr_decay: float = 0.95
    epochs: int = 20
    batch_size: int = 8192
    # temporal terms (as TimeSVDConfig)
    n_bins: int = 30
    beta: float = 0.4
    lr_t: float | None = None
    reg_t: float | None = None
    lr_alpha: float | None = None
    reg_alpha: float | None = None  # None -> 10*reg
    # implicit term (as SVDPPConfig)
    lr_y: float | None = None
    reg_y: float | None = None
    y_trust: float = 16.0
    partitioner: str = "fixed"  # 'fixed' | 'conflict_free'
    dup_trust: float = 0.0
    # 'jnp' — snapshot-minibatch temporal epoch (full per-term schedule);
    # 'pallas' — the temporal epoch over X = P + S rides the fused
    #            blocked kernel (lane-carried bin/drift; one lr/reg for
    #            all SGD terms, n_bins <= rank-4). The exact Y step is
    #            batched MXU work on either kernel.
    kernel: str = "jnp"

    def __post_init__(self):
        if self.partitioner not in ("fixed", "conflict_free"):
            raise ValueError(
                "timesvdpp.partitioner must be 'fixed' or "
                f"'conflict_free', got {self.partitioner!r}"
            )
        if self.n_bins < 1:
            raise ValueError(
                f"timesvdpp.n_bins must be >= 1, got {self.n_bins}"
            )
        if self.kernel not in ("jnp", "pallas"):
            raise ValueError(
                f"timesvdpp.kernel must be 'jnp' or 'pallas', got "
                f"{self.kernel!r}"
            )


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    reg: float = 0.05
    sweeps: int = 10
    user_chunk: int = 8192  # rows solved per batched-Cholesky call
    # ring-sharded mode: where the once-per-run piece plan's O(n log n)
    # sort / slab scatter / group bounds run ('device' = accelerator,
    # host only sees O(S^2 * block) degree summaries; bitwise-identical
    # plans either way — same stable sort key). 'auto' = device on TPU.
    plan_device: str = "auto"

    def __post_init__(self):
        if self.plan_device not in ("auto", "host", "device"):
            raise ValueError(
                "als.plan_device must be 'auto', 'host' or 'device', "
                f"got {self.plan_device!r}"
            )


@dataclasses.dataclass(frozen=True)
class NMFConfig:
    """Weighted NMF (mfx/solvers/nmf.py): non-negative factor tables via
    multiplicative updates on the ALS normal-equation blocks — the
    interpretable-factors member of the explicit MF family."""

    reg: float = 0.02
    sweeps: int = 20
    inner_iters: int = 2  # MU iterations per half-sweep on fixed (A, b)
    user_chunk: int = 8192  # rows per batched accumulate/update call
    # ring-sharded piece planning: 'device' / 'host' / 'auto' (device on
    # TPU backends) — same semantics as als.plan_device
    plan_device: str = "auto"

    def __post_init__(self):
        if self.plan_device not in ("auto", "host", "device"):
            raise ValueError(
                "nmf.plan_device must be 'auto', 'host' or 'device', "
                f"got {self.plan_device!r}"
            )


@dataclasses.dataclass(frozen=True)
class IALSConfig:
    """Implicit-feedback weighted ALS (mfx/solvers/ials.py): confidence
    c = 1 + alpha·r toward a binary preference target, solved in closed
    form per row — the non-sampling counterpart of BPR for configs[4]-
    style implicit data."""

    alpha: float = 40.0  # confidence slope (Hu/Koren/Volinsky's default)
    reg: float = 0.1
    sweeps: int = 8
    user_chunk: int = 8192  # rows solved per batched-Cholesky call
    # ring-sharded mode: planner placement, as ALSConfig.plan_device
    plan_device: str = "auto"

    def __post_init__(self):
        if self.plan_device not in ("auto", "host", "device"):
            raise ValueError(
                "ials.plan_device must be 'auto', 'host' or 'device', "
                f"got {self.plan_device!r}"
            )


@dataclasses.dataclass(frozen=True)
class BPRConfig:
    lr: float = 0.05
    reg: float = 0.002
    epochs: int = 10
    batch_size: int = 16384
    neg_seed: int = 0
    # 'jnp'    — snapshot-minibatch XLA gather/scatter path
    # 'pallas' — fused one-hot MXU kernel inside the DSGD ring
    #            (sharded/hybrid modes; mfx/kernels/bpr_pallas.py) with
    #            window-local exact negatives
    kernel: str = "jnp"
    ublock: int = 512  # fused path: user rows per block
    iblock: int = 512  # fused path: item rows per window
    tile: int = 256  # fused path: triples per tile
    # where per-epoch triple prep (permutation, negative sampling with
    # exact rejection, ring stratification) runs:
    # 'device' — jax.random + sorted-pair binary search on the
    #            accelerator; per-epoch host work is O(1)
    # 'host'   — vectorized NumPy (the round-2 path; minutes per epoch of
    #            1-core time at configs[4] scale)
    # 'auto'   — device on TPU backends, host otherwise
    sample_device: str = "auto"
    # negative-sampling proposal measure:
    # 'uniform'    — uniform over the catalog (exact: complement draw /
    #                rejection); the BPR paper's sampler
    # 'popularity' — P(i) ∝ count(i)**neg_beta (word2vec-style adaptive
    #                oversampling: popular items make harder negatives).
    #                Snapshot-minibatch ('jnp') paths only — the fused
    #                ring kernel's window-local complement draw is
    #                uniform by construction.
    neg_weighting: str = "uniform"
    neg_beta: float = 0.75

    def __post_init__(self):
        if self.sample_device not in ("auto", "host", "device"):
            raise ValueError(
                "bpr.sample_device must be 'auto', 'host' or 'device', "
                f"got {self.sample_device!r}"
            )
        if self.kernel not in ("jnp", "pallas"):
            raise ValueError(
                f"bpr.kernel must be 'jnp' or 'pallas', got {self.kernel!r}"
            )
        if self.neg_weighting not in ("uniform", "popularity"):
            raise ValueError(
                "bpr.neg_weighting must be 'uniform' or 'popularity', "
                f"got {self.neg_weighting!r}"
            )
        if self.neg_weighting == "popularity" and self.kernel == "pallas":
            raise ValueError(
                "bpr.neg_weighting='popularity' needs the snapshot-"
                "minibatch path (bpr.kernel='jnp'); the fused ring "
                "kernel's window-local exact negatives are uniform"
            )


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    # 'single'  — one device
    # 'dp'      — data-parallel SGD, sparse delta all-gather (P1)
    # 'sharded' — row-sharded factor tables, DSGD ring over ICI (P2)
    mode: str = "single"
    data_axis: int = 1  # mesh size along 'data'
    model_axis: int = 1  # mesh size along 'model'


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str = "default"
    # 'sgd' | 'svdpp' | 'timesvd' | 'timesvdpp' | 'als' | 'nmf' |
    # 'ials' | 'bpr'
    solver: str = "sgd"
    data: DataConfig = DataConfig()
    model: ModelConfig = ModelConfig()
    sgd: SGDConfig = SGDConfig()
    svdpp: SVDPPConfig = SVDPPConfig()
    timesvd: TimeSVDConfig = TimeSVDConfig()
    timesvdpp: TimeSVDPPConfig = TimeSVDPPConfig()
    als: ALSConfig = ALSConfig()
    nmf: NMFConfig = NMFConfig()
    ials: IALSConfig = IALSConfig()
    bpr: BPRConfig = BPRConfig()
    parallel: ParallelConfig = ParallelConfig()
    eval_every: int = 1
    # per-eval ranking metrics: HR/NDCG/MRR@K ('sampled' NCF-style or
    # 'full' catalog) or per-user Recall/Precision/NDCG/MAP +
    # coverage/novelty over the served lists ('user'); None disables.
    ranking_k: int | None = None
    ranking_protocol: str = "sampled"
    target_rmse: float | None = None
    clip_predictions: bool = True
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0  # epochs; 0 disables
    # async saves: snapshot to host, write in the background so the disk
    # write overlaps the next epoch's device work; train() flushes before
    # returning (and the final checkpoint always blocks), so callers see
    # complete checkpoints either way
    checkpoint_async: bool = True
    log_path: str | None = None  # JSONL sink
    profile_dir: str | None = None  # jax.profiler trace output
    # per-phase attribution in the JSONL records (single-device blocked
    # SGD): a one-time probe device-times the dense phases and sparse
    # sweeps standalone (dense_ms / sparse_ms), and every epoch record
    # carries plan_ms and eval_ms — so perf A/Bs land in artifacts, not
    # ad-hoc experiment logs (VERDICT r4 #7)
    profile_phases: bool = False


# ---- BASELINE.json config ladder (configs[0..4]) ---------------------------

PRESETS: dict[str, TrainConfig] = {
    # configs[0]: "MovieLens-100K, rank-16 plain SGD with L2 (single-host CPU,
    # matches Java reference RMSE)"
    "ml100k_rank16": TrainConfig(
        name="ml100k_rank16",
        data=DataConfig(dataset="ml-100k"),
        model=ModelConfig(rank=16, use_bias=False),
        sgd=SGDConfig(
            lr=0.01, reg=0.05, epochs=30, batch_size=2048, partitioner="conflict_free"
        ),
    ),
    # configs[1]: "MovieLens-1M, rank-32 biased MF (user/item/global bias
    # terms, learning-rate decay)"
    "ml1m_rank32_biased": TrainConfig(
        name="ml1m_rank32_biased",
        data=DataConfig(dataset="ml-1m"),
        model=ModelConfig(rank=32, use_bias=True),
        sgd=SGDConfig(
            lr=0.01, reg=0.04, lr_decay=0.92, epochs=30,
            partitioner="blocked", kernel="pallas",  # rank 32 -> pack 4
        ),
    ),
    # configs[2]: "MovieLens-25M, rank-64 minibatch SGD with conflict-free
    # partitioning on one TPU chip"
    "ml25m_rank64": TrainConfig(
        name="ml25m_rank64",
        data=DataConfig(dataset="ml-25m"),
        model=ModelConfig(rank=64, use_bias=True),
        sgd=SGDConfig(
            # lr swept on-chip at the v4 half-star gate: 0.012/0.95
            # reaches the target in ONE epoch (0.008 took 2) and tracks a
            # slightly lower floor at every epoch out to 6
            lr=0.012,
            reg=0.04,
            lr_decay=0.95,
            epochs=20,
            batch_size=1 << 16,
            partitioner="blocked",
            kernel="pallas",
            # su=si=1024 runs the sparse sweeps 1.19x faster than 512
            # (bigger one-hot matmuls, better tile fill) now that the
            # dense kernel's accumulator form keeps its VMEM stack flat
            # (round-2 blocker); tile=256 best measured on v5e
            ublock=1024,
            iblock=1024,
            tile=256,
            # full-span grouped dense phase: eligible strata anywhere in
            # the item span run densely. AUTO (<0): the dense/sparse
            # boundary comes from the cost model over the occupancy
            # histogram (mfx/solvers/dense_prep.py). On the v6
            # user-skewed generator 2-D carving beats all-dense 1.25x
            # within-job (r4 chi sweep: 72.9-73.1 ms at chi 0.001-0.0015
            # vs 91.3 ms all-dense; rGB 4.68 -> ~1.2; per-epoch test
            # RMSE identical to 4 decimals across the sweep) — the old
            # all-dense optimum (chi=0.0002) was an artifact of the
            # v4/v5 generator's FLAT iid user axis
            dense_chi=-1.0,
            dense_span="full",
            # lane-carried biases: deletes the per-tile bias machinery
            # (sparse path 94 -> 65 ms measured; epoch 104.5 -> 73.4 ms,
            # +42% upd/s) for 2 of the 64 latent dims — held-out RMSE
            # matches 'tile' from epoch 1 on (0.4038 vs 0.4040 at ep 3;
            # ep-0 is ~4e-4 behind, so epochs-to-gate is 2 instead of 1)
            bias_mode="lane",
        ),
        target_rmse=0.92,
    ),
    # configs[3]: "Netflix-Prize-scale 100M ratings, rank-128, data-parallel
    # SGD + ALS cross-check on v5p-8". The preset's configured path is the
    # FUSED Pallas kernel in the 8-shard DSGD ring (rank 128 = pack 1, with
    # the per-shard dense Zipf-head phase) — round 2 pinned the slow
    # kernel='jnp' scatter here (VERDICT round 2, Missing #5). The
    # plain-DP composition (fixed partitioner + segment-sum scatter with
    # dup_trust=16 guarding the Zipf head; add sgd.bias_mode=tile — lane
    # biases are a fused-kernel feature) remains available via
    # parallel.mode=dp overrides and is cross-checked against DP ALS in
    # tests/integration/test_als_sgd_crosscheck.py and
    # tests/integration/test_preset_convergence.py.
    "netflix100m_rank128_dp": TrainConfig(
        name="netflix100m_rank128_dp",
        solver="sgd",
        data=DataConfig(dataset="netflix"),
        model=ModelConfig(rank=128, use_bias=True),
        sgd=SGDConfig(
            lr=0.006,
            reg=0.05,
            lr_decay=0.95,
            epochs=15,
            batch_size=1 << 17,
            partitioner="blocked",
            kernel="pallas",
            # grouped full-span dense strata inside the ring (per-cell
            # carve on the held block; rank-128/512-block geometry
            # compile-verified on chip). AUTO: cost-model boundary from
            # the occupancy histogram, same machinery as the single-chip
            # full-span prep (the v6 generator is user-skewed here too)
            dense_chi=-1.0,
            dense_span="full",
            dup_trust=16.0,  # applies when overridden back to mode=dp
            # lane-carried biases work inside the DSGD ring too (2 of 128
            # latent dims; mesh-of-1 bitwise vs the single-chip lane path)
            bias_mode="lane",
        ),
        als=ALSConfig(reg=0.05, sweeps=8),
        parallel=ParallelConfig(mode="sharded", model_axis=8),
    ),
    # configs[4]: "Billion-rating implicit-feedback (BPR negative sampling),
    # sharded factor tables on v5p-32"
    "billion_bpr_sharded": TrainConfig(
        name="billion_bpr_sharded",
        solver="bpr",
        data=DataConfig(dataset="billion-implicit", test_frac=0.001),
        model=ModelConfig(rank=64, use_bias=False),
        # the fused one-hot MXU kernel inside the DSGD ring (round 3);
        # kernel='jnp' keeps the snapshot-minibatch scatter path
        bpr=BPRConfig(lr=0.05, reg=0.002, epochs=5, batch_size=1 << 17,
                      kernel="pallas"),
        parallel=ParallelConfig(mode="sharded", model_axis=32),
        # implicit track: report sampled HR/NDCG/MRR@10 alongside AUC
        ranking_k=10,
    ),
}


def preset(name: str) -> TrainConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name]


def _coerce(value: str, current: Any) -> Any:
    if current is None:
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        return None if value in ("none", "None", "null") else value
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    return type(current)(value)


def apply_overrides(cfg: TrainConfig, overrides: list[str]) -> TrainConfig:
    """Apply ``a.b=c`` style overrides to a (possibly nested) config."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must look like key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        path = key.split(".")
        cfg = _set_path(cfg, path, value)
    return cfg


def _set_path(obj, path: list[str], value: str):
    field = path[0]
    if not hasattr(obj, field):
        raise KeyError(f"{type(obj).__name__} has no field {field!r}")
    if len(path) == 1:
        return dataclasses.replace(obj, **{field: _coerce(value, getattr(obj, field))})
    return dataclasses.replace(
        obj, **{field: _set_path(getattr(obj, field), path[1:], value)}
    )
