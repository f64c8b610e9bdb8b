"""Typed configuration with YAML-preset + dotlist override merging.

The port's own copy of `wildgaussians_tpu/config.py`. Every field of the JAX
package's Config is kept, the TPU-only ones (`data_device`, `pallas_*`,
sharding) included, so that a checkpoint's `config.yaml` written by the JAX
package loads here: `merge_config` raises on unknown fields. The PyTorch port
reads the render fields (`sh_degree`, `kernel_size`, the appearance fields,
`max_tiles_per_gaussian`, `pallas_d_small`, `pallas_big_fraction`) and the
training schedule, learning rates, loss weights and store sizes; the rest
(the uncertainty model's, densification's thresholds, the TPU engines')
ride along unread.
"""
import dataclasses
import typing
from dataclasses import dataclass
from typing import Optional

import yaml

UncertaintyMode = str  # "disabled" | "l2reg" | "l1reg" | "dino" | "dino+mssim"


@dataclass
class Config:
    # --- core (reference config.py:15-29) ---
    source_path: str = ""
    model_path: str = ""
    sh_degree: int = 3
    images: str = "images"
    data_device: str = "tpu"
    eval: bool = False
    kernel_size: float = 0.1

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False

    num_sky_gaussians: int = 0
    use_background_model: bool = False
    background_lr: float = 0.001

    # --- optimization (reference config.py:31-46) ---
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002

    use_gof_abs_gradient: bool = True

    # --- appearance (reference config.py:51-74) ---
    appearance_n_fourier_freqs: int = 4
    n_gaussian_features: int = 4
    embedding_lr: float = 0.005
    embedding_regularization: float = 0.0

    appearance_enabled: bool = True
    enable_exposure_mlp: bool = True
    exposure_mlp_lr: float = 0.0001
    appearance_embedding_dim: int = 32
    appearance_embedding_lr: float = 0.001
    appearance_mlp_lr: float = 0.0005
    appearance_embedding_regularization: float = 0.0
    appearance_embedding_optim_lr: float = 0.1
    appearance_embedding_optim_iters: int = 128
    appearance_optim_type: str = "dssim+l1-scaled"
    appearance_separate_tuned_color: bool = True
    appearance_use_raw_colors: bool = False
    appearance_model_sh: bool = False
    appearance_model_2D: str = "disabled"
    appearance_conv_lr: float = 0.0005
    appearance_init_fourier: bool = True

    # --- uncertainty model (reference config.py:77-93) ---
    uncertainty_mode: UncertaintyMode = "dino"
    uncertainty_backbone: str = "dinov2_vits14_reg"
    uncertainty_regularizer_weight: float = 0.5
    uncertainty_clip_min: float = 0.1
    # TPU adaptation: letterbox the DINO working canvas (aspect-preserving,
    # like the reference's <=350px resize, method.py:190-201) instead of
    # squashing to a square; fixed-shape either way. Square inputs are
    # unaffected.
    uncertainty_dino_letterbox: bool = True
    uncertainty_mask_clip_max: Optional[float] = None
    uncertainty_dssim_clip_max: float = 1.0
    uncertainty_lr: float = 0.001
    uncertainty_dropout: float = 0.5
    uncertainty_dino_max_size: Optional[int] = None
    uncertainty_scale_grad: bool = False
    uncertainty_center_mult: bool = False
    uncertainty_after_opacity_reset: int = 1000
    uncertainty_protected_iters: int = 500
    uncertainty_preserve_sky: bool = False

    uncertainty_warmup_iters: int = 0
    uncertainty_warmup_start: int = 2000

    # --- TPU-specific (no reference counterpart) ---
    # Rasterizer backend: "pallas" (production), "tiled" (pure-XLA tiled),
    # "reference" (slow per-pixel oracle; tests only).
    rasterizer_backend: str = "auto"
    # Tile size in pixels (reference CUDA uses 16x16, config.h:15-17).
    tile_size: int = 16
    # Max tiles a single Gaussian may be duplicated into during binning
    # (duplication slot budget; overflow is monitored per step).
    max_tiles_per_gaussian: int = 16
    # Pallas two-tier slots: every Gaussian gets pallas_d_small cheap slots;
    # a pallas_big_fraction-capacity pool covers rect cells up to
    # max_tiles_per_gaussian for big-footprint Gaussians (sky etc.).
    pallas_d_small: int = 4
    pallas_big_fraction: float = 0.16
    # Entry binning inside the pallas backend: "sort" (one wide lax.sort —
    # fastest measured single-chip path) or "partition" (the radix engine;
    # forced automatically under a device mesh, where it is the only
    # shard-capable path)
    pallas_binning: str = "sort"
    # f16/rgb10-packed entry tables (pack-v2). False = exact-parity f32
    # rows (2x sort payload traffic); the quality A/B on the synthetic
    # scene measured no PSNR/densify difference (round 4, VERDICT r3 #9).
    pallas_pack16: bool = True
    # Saturation-aware pre-sort culling (round 5): cache each camera's
    # per-tile early-exit depths and drop binning cells behind them on the
    # next visit. The blend kernels' early exit (forward.cu:367-372
    # semantics) already skips the saturated tail at BLEND time; this
    # shrinks the BINNING work too. Self-correcting (an over-culled walk
    # stops saturating and the map resets to +inf) and invalidated on
    # densify/prune/opacity-reset. Single-chip pallas sort engine only.
    saturation_culling: bool = False
    # keep-band multiplier on the recorded exit depths (>1 = conservative)
    saturation_margin: float = 1.25
    # Sharded sort engine: per-(sender, band) all-to-all send capacity as a
    # multiple of the balanced load R_loc/D. Segments beyond the cap drop
    # (surfaced via the send_drops metric); the trainer auto-grows this on
    # persistent drops (_maybe_grow_tile_budget).
    pallas_send_beta: float = 2.0
    # Read by nothing: kept so that the JAX package's configs load. There it
    # picks the sharded sort engine's receive merge, a bitonic network
    # (True) or a stable sort (False); the two give one order
    # (tests/test_torch_mesh_sort.py holds it), and the port's engine
    # merges with the stable sort.
    pallas_stream_merge: bool = True
    # Total duplicated (gaussian, tile) key capacity as a multiple of capacity.
    binning_capacity_multiplier: float = 8.0
    # Depth sort: "quantized" (fused u32 key, fast) or "exact" (full f32 key).
    depth_sort_mode: str = "quantized"
    # Gaussian-store capacity management: capacity = next_pow2-ish multiple of
    # the live count; regrow (one recompile) when fill exceeds the watermark.
    capacity_growth_factor: float = 1.5
    capacity_high_watermark: float = 0.95
    initial_capacity: int = 0  # 0 = derived from the initial point count
    # Sharding: number of devices along the 'tiles' mesh axis (0 = all).
    mesh_tile_devices: int = 0
    # Shard the Gaussian store (params/Adam/aux) over the mesh axis inside
    # the train step: 1/D memory per device end-to-end (preprocess, Adam,
    # densify stats), feeding the sharded sort engine with no resharding
    # and shard-owned gradients. The store-updating functions run as
    # AOT-compiled executables under a mesh (wildgaussians._aot_under_mesh)
    # because jax 0.9's C++ dispatch fastpath mis-executes the third call
    # of jits containing the engine's shard_map+all_to_all. False (leave
    # interface shardings to GSPMD) is only valid for single-function use:
    # in multi-step training the step/densify/reset executables pick
    # DISAGREEING interface shardings and the handoff fails.
    shard_gaussian_store: bool = True
    # Mixed-resolution train canvases: 0 pads every train image to the
    # dataset-wide max (one compiled step). >0 rounds each image's canvas up
    # to this multiple instead, compiling one step program per distinct
    # bucket — Photo Tourism images vary wildly, so pad-to-max wastes
    # compute and HBM; larger multiples trade padding waste for fewer
    # compiles.
    size_bucket_multiple: int = 0
    # Seed for all JAX randomness.
    seed: int = 0


def _coerce(value, ann):
    """Coerce a YAML/string value to a dataclass field's annotated type."""
    origin = typing.get_origin(ann)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if value is None or (isinstance(value, str) and value.lower() in ("none", "null")):
            return None
        return _coerce(value, args[0])
    if ann is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes", "on"):
                return True
            if value.lower() in ("false", "0", "no", "off"):
                return False
            raise ValueError(f"Cannot parse bool from {value!r}")
        return bool(value)
    if ann is int:
        return int(value)
    if ann is float:
        return float(value)
    if ann is str:
        return str(value)
    return value


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}


def merge_config(config: Config, overrides: dict) -> Config:
    """Merge a flat dict of overrides into a Config (OmegaConf.merge analogue)."""
    changes = {}
    for key, value in overrides.items():
        if key not in _FIELD_TYPES:
            raise ValueError(f"Unknown config field: {key}")
        ann = _FIELD_TYPES[key]
        if isinstance(ann, str):
            ann = eval(ann)  # noqa: S307 - dataclass annotations in this module
        changes[key] = _coerce(value, ann)
    return dataclasses.replace(config, **changes)


def load_config_yaml(path: str, base: Optional[Config] = None) -> Config:
    """Load a YAML preset on top of defaults (or `base`)."""
    with open(path, "r", encoding="utf8") as f:
        data = yaml.safe_load(f) or {}
    return merge_config(base if base is not None else Config(), data)


def config_from_dotlist(config: Config, dotlist: dict) -> Config:
    """Apply `--set k=v` style overrides (reference method.py:1669-1670)."""
    return merge_config(config, dotlist)


def config_to_yaml(config: Config) -> str:
    return yaml.safe_dump(dataclasses.asdict(config), sort_keys=False)


def config_from_yaml_str(text: str, base: Optional[Config] = None) -> Config:
    data = yaml.safe_load(text) or {}
    return merge_config(base if base is not None else Config(), data)
