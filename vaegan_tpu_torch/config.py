"""Configuration tree for the PyTorch/CUDA port.

A copy of ``vaegan_tpu/config.py`` kept in this package so the port imports
nothing of the JAX package: the same frozen dataclass tree, the same presets and
the same JSON round trip, so a ``Config.to_json()`` written by either package
loads in the other unchanged. ``TrainConfig.use_pallas`` keeps its values
``off|losses|all``; in the port it switches the hand-written CUDA kernels
(``vaegan_tpu_torch.ops.fused``) instead of the Pallas ones.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def pallas_mode(v) -> str:
    """Normalize TrainConfig.use_pallas to "off"|"losses"|"all"."""
    if v is True:
        return "all"
    if v is False or v is None:
        return "off"
    if v not in ("off", "losses", "all"):
        raise ValueError(f"use_pallas must be 'off'|'losses'|'all' (or bool), got {v!r}")
    return v


def _freeze(seq):
    return tuple(seq) if isinstance(seq, (list, tuple)) else seq


class _Replaceable:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GeneratorConfig(_Replaceable):
    """Architecture of the residual VAE generator (reference README.md:204-294, 522-597).

    ``feature_depth`` (the latent channel count) is derived as
    ``feature_size * 2**depth`` exactly like reference README.md:882.
    """

    in_channels: int = 1
    depth: int = 2            # number of down/up-sample stages
    length: int = 1           # ResBlocks per resolution level
    feature_size: int = 64    # channels after the first block; doubles per stage
    res_mode: str = "pre-activation"   # or "standard" (README.md:139-197)
    dropout_prob: float = 0.5
    logvar_bound: float = 50.0         # clamp of log-variance (README.md:549-550)
    is_vae: bool = True

    @property
    def feature_depth(self) -> int:
        return self.feature_size * (2 ** self.depth)


@dataclass(frozen=True)
class DiscriminatorConfig(_Replaceable):
    """Critic architecture (reference README.md:422-498).

    The reference hardcodes ``input_size = [1, 256, 256]`` (README.md:435); here the
    flatten width of the first linear layer is derived from the actual input shape at
    init time, so any resolution works (BASELINE configs 1 vs 5).
    """

    in_channels: int = 1
    num_stride_conv1: int = 1
    num_features_conv1: int = 64
    num_blocks: Tuple[int, ...] = (1, 1, 1)
    num_strides_res: Tuple[int, ...] = (1, 2, 2)
    num_features_res: Tuple[int, ...] = (128, 256, 512)
    res_mode: str = "pre-activation"
    dropout_prob: float = 0.5
    pool_size: int = 4                 # avg_pool2d window (README.md:471)
    linear_widths: Tuple[int, ...] = (1024, 512, 256)  # README.md:458-461
    # Which activation to tap as the Dis_l feature space for feature-matching
    # reconstruction loss (Larsen et al. §3): "res_out" (after the residual stages),
    # "pool" (after avg-pool), or "fc1" (after the first linear + LeakyReLU).
    feature_tap: str = "res_out"

    def __post_init__(self):
        object.__setattr__(self, "num_blocks", _freeze(self.num_blocks))
        object.__setattr__(self, "num_strides_res", _freeze(self.num_strides_res))
        object.__setattr__(self, "num_features_res", _freeze(self.num_features_res))
        object.__setattr__(self, "linear_widths", _freeze(self.linear_widths))
        valid_taps = {"res_out", "pool"} | (
            {"fc1"} if self.linear_widths else set())
        if self.feature_tap not in valid_taps:
            raise ValueError(
                f"feature_tap must be one of {sorted(valid_taps)} for this "
                f"architecture, got {self.feature_tap!r}"
                + ("" if self.linear_widths else
                   " ('fc1' needs a non-empty linear_widths)"))


@dataclass(frozen=True)
class LossConfig(_Replaceable):
    """Loss shape. The reference trains WGAN-GP-style with pixel L1+MSE recon and a
    batch-and-dims summed KL (README.md:792-831); the paper-faithful BASELINE config 3
    uses BCE adversarial + Dis_l feature-matching recon instead.
    """

    adversarial: str = "wgan"          # "wgan" | "bce" | "none"
    reconstruction: str = "pixel"      # "pixel" (L1+MSE, README.md:921) | "dis_l"
    adversarial_weight: float = 1.0
    reconstruction_weight: float = 10.0
    kl_weight: float = 0.1
    kl_reduction: str = "sum"          # "sum" (reference README.md:822-825) | "mean"
    # Dis_l pair under ONE critic-dropout draw (three-opt step only). The
    # notebook critic's Dropout2d p=0.5 is absent from Larsen's discriminator;
    # independent masks on the real/x_tilde forwards give the feature-matching
    # MSE an irreducible ~2·E[f^2] noise floor that buries the reconstruction
    # signal at batch 4 (measured, result/paper_probes). False = independent
    # masks (the pre-round-5 behavior).
    dis_l_shared_dropout: bool = True
    lambda_gp: float = 10.0            # gradient-penalty weight (README.md:763)
    clip_value: Optional[float] = 0.01  # post-step D weight clamp (README.md:805-806);
    # None disables (the clamp on top of GP is a reference quirk, kept as default)


@dataclass(frozen=True)
class OptimConfig(_Replaceable):
    """Optimizers. Reference: two RMSprop(lr, wd=1e-5) (README.md:918-919).
    ``scheme="three"`` = paper-faithful per-network (enc / dec / disc) optimizers with
    the Larsen et al. loss split.
    """

    scheme: str = "two"                # "two" (notebook) | "three" (paper)
    optimizer: str = "rmsprop"         # torch-semantics rmsprop | "adam"
    lr: float = 3e-4
    # per-network learning rates (TTUR-style split): None = use ``lr``. The
    # reference's search schema already envisaged a lr_generator /
    # lr_discriminator split (README.md:1048-1059) though its live code never
    # accepted one; the large-batch recipe needs it (see preset vaegan_256_dp).
    lr_g: Optional[float] = None
    lr_d: Optional[float] = None
    weight_decay: float = 1e-5
    rms_decay: float = 0.99            # torch RMSprop alpha
    eps: float = 1e-8
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    # decoder's feature-matching weight gamma (Larsen alg. 1), three-opt only
    gamma: float = 1.0


@dataclass(frozen=True)
class DataConfig(_Replaceable):
    root_dir: str = "nii"
    image_size: int = 96               # BASELINE: resize to 96x96 (configs 1-4)
    batch_size: int = 4
    shuffle: bool = True
    drop_last: bool = False
    num_workers: int = 4               # host-side decode threads
    prefetch: int = 2                  # device-buffer depth
    synthetic: bool = False            # on-device synthetic data (benchmarks)
    synthetic_size: int = 1200         # ~dataset size of the reference (README.md:970)
    synthetic_style: str = "blobs"     # "blobs" (smooth) | "edges" (sharp
    #                                    iso-contours — the high-frequency regime
    #                                    where the adversarial term has MSE upside)
    #                                    | "texture" (resolution-proportional
    #                                    fine structure: the edge-pixel fraction
    #                                    holds at 256^2 like real X-ray texture;
    #                                    see data.pipeline.SyntheticDataset)
    cache: bool = False                # decode-once memmapped dataset cache
    cache_path: Optional[str] = None   # default: <root_dir>/.cache_<size>.npy
    # Stage the whole decoded dataset in device memory (HBM) once and gather
    # each batch on-device from staged images + tiny index transfers — removes
    # the per-step host->device image feed entirely. Fits when
    # N * H * W * 4 bytes is small vs HBM (the reference's ~1200-image dataset
    # is 44 MB at 96^2, 315 MB at 256^2). Single-process runs only (each
    # process would otherwise need the full dataset addressable); epoch
    # shuffle order is IDENTICAL to the host loader's (same RNG stream).
    hbm_cache: bool = False


@dataclass(frozen=True)
class ParallelConfig(_Replaceable):
    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1                 # -1 = all visible devices
    num_model: int = 1


@dataclass(frozen=True)
class TrainConfig(_Replaceable):
    n_epochs: int = 3
    n_critics: int = 1                 # G updated every n_critics steps (README.md:812)
    # gradient accumulation: split each global batch into this many microbatches
    # scanned sequentially (lax.scan) with ONE optimizer update per step —
    # emulates large global batches on one chip (SURVEY.md §2.3). Equivalent to
    # the full-batch step up to per-microbatch BN statistics and spectral-norm
    # power-iteration cadence (see make_accum_train_step / the paper-step
    # accumulation variant).
    grad_accum: int = 1
    # hard step budget: stop after this many optimizer steps regardless of
    # n_epochs (None = unbounded). Bounds e.g. hyperparameter-search trials —
    # the reference's search ran full multi-epoch experiments per trial
    # (README.md:1177-1198)
    max_steps: Optional[int] = None
    sample_interval: int = 20          # image-grid dump cadence (README.md:853); <=0 disables
    sample_dir: str = "gan_inference"
    log_every: int = 1                 # metric host-flush cadence (steps)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    seed: int = 0
    dtype: str = "float32"             # compute dtype: "float32" | "bfloat16"
    # PRNG implementation for the training key stream ("rbg" | "threefry2x32").
    # rbg is the TPU-friendly counter RNG: ~15% faster generator forward at 96x96
    # (dropout/reparam mask generation off the critical path); this default is
    # exactly what bench.py measures, so the headline number is the shipped loop.
    rng_impl: str = "rbg"
    # fused Pallas kernels: "off" | "losses" (reparam+KL, recon sums) | "all"
    # (also fuse the res-block BN+act+dropout chains). bool accepted: True="all".
    # Default "off" by round-4 paired measurement (BENCH_NOTES.md): the custom-
    # call boundary blocks XLA's own fusion of the loss section, costing 1.1-
    # 1.2% on the WGAN steps and 14% on the three-opt paper step, while the
    # TPU's byte audit shows plain-jnp already schedules the loss math at the
    # fused ideal (1.05x its conservative bound; the audit's port is
    # ``python -m vaegan_tpu_torch.tools.paper_loss_fusion_evidence``).
    use_pallas: Any = "off"
    remat: bool = False                # jax.checkpoint the generator blocks
    init_scheme: str = "reference"     # faithful init quirks (README.md:700-707) | "clean"
    nan_check: bool = False            # per-flush finite-metrics check (forces a host
    # sync at the flush cadence; raises TrainingDiverged with step context)
    # critic real/fake scoring: "separate" = one apply per batch, torch-reference
    # BN semantics (each apply normalizes with its own batch statistics,
    # README.md:792-793); "concat" = single apply over concat(real, fake) — fewer,
    # larger kernels, BN stats over the mixed batch (a documented deviation many
    # GAN implementations use); "concat3" = also fold the GP interpolates into
    # the same apply (measured −38% on TPU, BENCH_NOTES.md — kept as an
    # experiment knob)
    critic_batching: str = "separate"
    # generator weight EMA (opt-in; the reference has none). When set (e.g.
    # 0.999), the train step maintains an exponential moving average of the
    # generator params, refreshed after every G-optimizer update; evaluate it
    # via ``inference.with_ema(state)``. A standard GAN stabilizer: the EMA
    # iterate averages over the adversarial game's oscillations. Sizing note
    # (measured, BENCH_NOTES.md): the EMA horizon is ~1/(1-decay) G-steps —
    # 0.999 needs runs >> 1,000 G-steps. It rescued the large-batch preset
    # (1,800 steps: 0.96 live -> 0.053 EMA) but is useless-to-harmful on the
    # reference's short batch-4 recipe (900 steps: 0.04 live vs 0.46 EMA).
    ema_decay: Optional[float] = None
    # lazy gradient-penalty cadence (opt-in; 1 = the reference's every-step GP).
    # When k > 1 the shipped schedulers (train(), train_data_parallel, bench,
    # the probe tool) run the WGAN-GP term (and its grad-of-grad) only every
    # k-th step, passing gp_lambda_scale=k to the step builder so lambda_gp is
    # scaled by k on those steps and the time-averaged regularization pressure
    # is unchanged — StyleGAN2's "lazy regularization" (Karras et al. 2020,
    # appendix B) applied to WGAN-GP. A step built DIRECTLY from this config
    # ignores gp_every (faithful λ every step): the scaling belongs to whoever
    # actually skips steps. Amortizes the penalty's extra critic forward +
    # double-backprop across k steps; a documented beyond-reference throughput
    # lever, NOT semantics-preserving.
    gp_every: int = 1

    def __post_init__(self):
        if self.gp_every < 1:
            raise ValueError(f"gp_every must be >= 1, got {self.gp_every!r}")
        if self.critic_batching not in ("separate", "concat", "concat3"):
            raise ValueError(
                f"critic_batching must be one of 'separate'|'concat'|'concat3', "
                f"got {self.critic_batching!r}")
        if self.ema_decay is not None and not (0.0 < self.ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {self.ema_decay!r}")
        pallas_mode(self.use_pallas)  # asserts on invalid values


@dataclass(frozen=True)
class Config(_Replaceable):
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def __post_init__(self):
        # the encoder halves the resolution generator.depth times and the
        # decoder exactly doubles it back; a non-divisible size cannot
        # round-trip (100 -> ceil chain -> 13 -> 104) and would desync
        # latent_shape/serving specs. Fail at config time, not trace time.
        f = 2 ** self.generator.depth
        if self.data.image_size % f:
            raise ValueError(
                f"data.image_size={self.data.image_size} must be divisible by "
                f"2**generator.depth={f} for an exact encode/decode round-trip")

    # ------------------------------------------------------------------ json io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return Config(
            generator=GeneratorConfig(**d.get("generator", {})),
            discriminator=DiscriminatorConfig(**d.get("discriminator", {})),
            loss=LossConfig(**d.get("loss", {})),
            optim=OptimConfig(**d.get("optim", {})),
            data=DataConfig(**d.get("data", {})),
            parallel=ParallelConfig(**d.get("parallel", {})),
            train=TrainConfig(**d.get("train", {})),
        )

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

# ---------------------------------------------------------------------------
# Named presets: the five BASELINE.json configs + the notebook's exact runs.
# ---------------------------------------------------------------------------

def _notebook_disc() -> DiscriminatorConfig:
    # reference README.md:952-958
    return DiscriminatorConfig(
        num_stride_conv1=1, num_features_conv1=64,
        num_blocks=(1, 1, 1), num_strides_res=(1, 2, 2),
        num_features_res=(128, 256, 512),
    )


def _dummy_disc() -> DiscriminatorConfig:
    # reference README.md:1297-1303 (plain-VAE run keeps a 1-feature dummy critic)
    return DiscriminatorConfig(
        num_stride_conv1=1, num_features_conv1=1,
        num_blocks=(1,), num_strides_res=(1,), num_features_res=(1,),
    )


def preset(name: str) -> Config:
    """Named configurations.

    - ``vae_96``        — BASELINE config 1: plain VAE (adv weight 0), 96x96, batch 4.
    - ``gan_only``      — BASELINE config 2: discriminator-only DCGAN-style BCE training.
      Note: with no reconstruction anchor the BCE game is D-dominant at short
      budgets (D loss -> 0 while G keeps learning under the non-saturating
      loss). At a DCGAN-class budget the game DOES reach the anchored
      configs' quality band (held-batch recon proxy below the mean-predictor
      floor by step ~2.5k at 96^2 b64) but does not HOLD it — the equilibrium
      oscillates and degrades after ~10k steps
      (``python -m vaegan_tpu_torch.tools.gan_only_budget``, BENCH_NOTES.md
      round 4); the anchored configs (1, 3, 5) buy stability, and remain the
      quality-verified ones. Operational recipe (round 5, measured on the TPU
      through a full 20k-step divergence): run with ``python -m
      vaegan_tpu_torch.tools.gan_only_budget --keep-best`` — the on-device
      best-iterate snapshot retains the curve minimum (proxy 0.0117, below
      the mean-predictor floor, at step ~2.5k) while the live endpoint
      diverges (result/gan_only_keepbest/).
    - ``vaegan_paper``  — BASELINE config 3: Dis_l feature matching + BCE + three optimizers.
    - ``vaegan_infer``  — BASELINE config 4: inference/generation-path config.
    - ``vaegan_256_dp`` — BASELINE config 5: 256x256, large batch, data parallel.
    - ``notebook``      — the reference notebook's exact VAE-GAN run (README.md:938-961).
    - ``notebook_vae``  — the reference's plain-VAE ablation (README.md:1283-1306).
    """
    base = Config()
    if name == "notebook":
        return base.replace(discriminator=_notebook_disc(), data=base.data.replace(image_size=256))
    if name == "notebook_vae":
        return base.replace(
            discriminator=_dummy_disc(),
            loss=base.loss.replace(adversarial_weight=0.0),
            data=base.data.replace(image_size=256),
        )
    if name == "vae_96":
        return base.replace(
            discriminator=_dummy_disc(),
            loss=base.loss.replace(adversarial="none", adversarial_weight=0.0),
        )
    if name == "gan_only":
        return base.replace(
            discriminator=_notebook_disc(),
            loss=base.loss.replace(
                adversarial="bce", reconstruction_weight=0.0, kl_weight=0.0,
                clip_value=None, lambda_gp=0.0,
            ),
        )
    if name == "vaegan_paper":
        # Round-5 quality findings (result/paper_probes, BENCH_NOTES r5): with
        # the notebook's 140M SN critic the BCE game starts saturated (|logit|
        # ~100-500 from the unconstrained 131072-wide head) and at gamma=1 the
        # decoder never learns pixel structure (eval MSE ~1.4-26 vs floor
        # 0.02). gamma=100 (Larsen's decoder feature-matching weight) lets the
        # game unsaturate around step ~1k, after which it OSCILLATES: the
        # EMA iterate reaches the pixel-configs' band transiently (96^2 3-seed
        # EMA minima 0.034/0.053/0.062) and the endpoint diverges. The
        # operational recipe is therefore gamma=100 + ema_decay=0.999 +
        # best-iterate selection on a held batch (``python -m
        # vaegan_tpu_torch.tools.paper_probe --keep-best``), like config 2's
        # DCGAN-budget recipe.
        return base.replace(
            discriminator=_notebook_disc(),
            loss=base.loss.replace(
                adversarial="bce", reconstruction="dis_l", clip_value=None,
                lambda_gp=0.0, kl_reduction="mean",
                adversarial_weight=1.0, reconstruction_weight=1.0, kl_weight=1.0,
            ),
            optim=base.optim.replace(scheme="three", gamma=100.0),
            train=base.train.replace(ema_decay=0.999),
        )
    if name == "vaegan_infer":
        return preset("notebook")
    if name == "vaegan_256_dp":
        # Large-batch recipe (BENCH_NOTES "converging large-batch recipe"):
        # keep the reference's adversarial dynamics untouched and evaluate the
        # generator-EMA iterate. Measured head-to-head at 96^2 b128 against lr
        # scaling / TTUR / unclipping / n_critics=5: EMA is the only lever that
        # improves a destabilizing seed (0.125 -> 0.066) without hurting a
        # converging one (n_critics=5 helped the bad seed but cost the good
        # seed 0.045 -> 0.114).
        return base.replace(
            discriminator=_notebook_disc(),
            data=base.data.replace(image_size=256, batch_size=64),
            train=base.train.replace(dtype="bfloat16", ema_decay=0.999),
        )
    raise ValueError(f"unknown preset {name!r}")
