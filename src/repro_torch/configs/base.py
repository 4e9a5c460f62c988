"""Config registry: architectures x input shapes (port of
``repro.configs.base``).

Each arch module defines ``full()`` (the exact published config) and
``smoke()`` (a reduced same-family config for CPU tests), registered via
``register``. ``input_specs`` gives the model inputs of one (arch x shape)
cell as tensors on the ``meta`` device, which carry shape and dtype and
allocate nothing (the torch counterpart of the reference's
``ShapeDtypeStruct`` stand-ins); ``cache_specs`` is ``init_cache`` on that
device.

The paper's technique is selected per-run with ``method``:
    "vanilla" | "clipped_softmax" | "gated_attention"
applied uniformly to every softmax-attention block of any arch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.gating import GateConfig
from repro_torch.core.softmax import ClippedSoftmaxConfig
from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                          # moe | dense | vlm | hybrid | ssm | audio
    full: Callable[..., ModelConfig]     # full() -> published config
    smoke: Callable[..., ModelConfig]    # smoke() -> reduced config
    # shapes this arch skips, with the reason
    skip_shapes: Tuple[Tuple[str, str], ...] = ()
    source: str = ""

    def skipped(self, shape: str) -> Optional[str]:
        for s, why in self.skip_shapes:
            if s == shape:
                return why
        return None


_REGISTRY: Dict[str, ArchSpec] = {}

SKIP_LONG = ("long_500k",
             "full softmax attention is quadratic; 500k decode reserved for "
             "sub-quadratic archs per assignment")
SKIP_DECODE_ENC = ("decode_32k", "encoder-only architecture has no autoregressive step")
SKIP_LONG_ENC = ("long_500k", "encoder-only architecture has no autoregressive step")


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import arch modules for registration side-effects
    from repro_torch.configs import (  # noqa: F401
        codeqwen1_5_7b,
        deepseek_67b,
        gemma2_27b,
        granite_moe_1b_a400m,
        hubert_xlarge,
        paper_models,
        phi_3_vision_4_2b,
        qwen2_moe_a2_7b,
        qwen3_14b,
        recurrentgemma_9b,
        xlstm_1_3b,
    )


def apply_method(cfg: ModelConfig, method: str,
                 gamma: float = -0.03, alpha: Optional[float] = None,
                 zeta: float = 1.0, pi_init: float = 0.5,
                 gate_kind: str = "linear") -> ModelConfig:
    """Inject the paper's technique into any ModelConfig."""
    if method == "vanilla":
        return dataclasses.replace(
            cfg, softmax_cfg=ClippedSoftmaxConfig(), gate_cfg=GateConfig(kind="none"))
    if method == "clipped_softmax":
        sm = ClippedSoftmaxConfig(gamma=gamma, zeta=zeta, alpha=alpha)
        return dataclasses.replace(cfg, softmax_cfg=sm, gate_cfg=GateConfig(kind="none"))
    if method == "gated_attention":
        return dataclasses.replace(
            cfg, softmax_cfg=ClippedSoftmaxConfig(),
            gate_cfg=GateConfig.from_pi_init(pi_init, gate_kind))
    raise ValueError(f"unknown method {method!r}")


# --------------------------------------------------------------------------
# Input specs (meta-device tensors: shape and dtype, no allocation)
# --------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Model inputs for one cell. Decode cells additionally need the cache
    spec — see ``cache_specs``."""
    b, t = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.step in ("train", "prefill"):
        if cfg.input_kind == "tokens":
            specs = {"tokens": _spec((b, t), i32)}
        elif cfg.input_kind == "embeds":
            specs = {"embeds": _spec((b, t, cfg.frontend_dim or cfg.d_model), f32)}
        else:
            # mixed (vlm): image-patch prefix + text tokens
            n_img = cfg.n_prefix_embeds
            specs = {"embeds": _spec((b, n_img, cfg.d_model), f32),
                     "tokens": _spec((b, t - n_img), i32)}
        if shape.step == "train":
            specs["labels"] = _spec((b, t), i32)
        return specs
    # decode: one new token against a seq_len cache
    return {"tokens": _spec((b, 1), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache of one cell as meta-device tensors (``init_cache``
    on the ``meta`` device)."""
    from repro_torch.models.transformer import init_cache

    cfg_sized = dataclasses.replace(cfg, max_seq_len=max(shape.seq_len, cfg.window or 0))
    return init_cache(cfg_sized, shape.global_batch, shape.seq_len,
                      dtype=cfg.compute_dtype, device="meta")


def to_bf16(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
