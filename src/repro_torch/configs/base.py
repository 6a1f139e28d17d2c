"""Architecture + shape configuration system (a copy of
``repro.configs.base``, so the port never imports the JAX package).

Every assigned architecture is a frozen :class:`ArchConfig`; every workload
shape is a :class:`ShapeSpec`.  Configs are *data*, never code: the model
assembly in ``repro_torch.models.lm`` interprets them.  The registry loads
the ten architecture files of this package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # Every ``period``-th layer (offset ``offset``) uses the MoE MLP; others
    # use the dense MLP.  period=1 -> every layer is MoE.
    period: int = 1
    offset: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyperparameters."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length for the matmul-form scan


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid interleave: within each block of ``attn_period`` layers, layer
    # index ``attn_offset`` is attention, the rest are SSM (jamba-style 1:7).
    attn_period: int = 0
    attn_offset: int = 0
    sliding_window: int = 0  # 0 -> full attention
    # encoder-decoder
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: none | vision | audio.  Frontend embeddings are
    # provided pre-computed by input_specs() per the assignment instructions.
    frontend: str = "none"
    n_frontend_tokens: int = 0  # e.g. image patches prepended to the text seq
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # source tag from the assignment table
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived quantities -------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer i of the backbone."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_period:
            return "attn" if (i % self.attn_period) == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.period) == self.moe.offset

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can run the 500k-token long-context shape.

        SSM and hybrid archs are O(s) per token; sliding-window attention
        bounds the KV cache at the window size.  Pure full-attention archs
        are excluded per the assignment instructions.
        """
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    # -- parameter count (exact, mirrors models.lm.init) --------------------
    def param_counts(self) -> dict:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        counts = {"embed": V * d, "head": 0 if self.tie_embeddings else d * V,
                  "final_norm": d}
        attn_p = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        dense_mlp = 3 * d * ff  # SwiGLU: w_gate, w_up, w_down
        ssm_p = 0
        if self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            ds, ng, cw = self.ssm.d_state, self.ssm.n_groups, self.ssm.conv_width
            conv_dim = di + 2 * ng * ds
            ssm_p = (
                d * (2 * di + 2 * ng * ds + nh)  # in_proj (z,x,B,C,dt)
                + conv_dim * cw                   # depthwise conv
                + nh                              # A_log
                + nh                              # D skip
                + nh                              # dt_bias
                + di * d                          # out_proj
                + di                              # pre-out norm
            )
        total = counts["embed"] + counts["head"] + counts["final_norm"]
        act_total = total  # "active" params for MoE MODEL_FLOPS
        n_backbone = self.n_layers
        for i in range(n_backbone):
            kind = self.layer_kind(i)
            has_mlp = self.layer_is_moe(i) or ff > 0
            lp = d * (2 if has_mlp else 1)  # RMSNorm scales
            lp_act = lp
            if kind == "attn":
                lp += attn_p
                lp_act += attn_p
            else:
                lp += ssm_p
                lp_act += ssm_p
            if self.layer_is_moe(i):
                m = self.moe
                lp += m.n_experts * dense_mlp + d * m.n_experts  # experts+router
                lp_act += m.top_k * dense_mlp + d * m.n_experts
            else:
                lp += dense_mlp
                lp_act += dense_mlp
            total += lp
            act_total += lp_act
        if self.is_encoder_decoder:
            # encoder layers (full attn, dense MLP) + cross-attention in
            # decoder layers + the encoder's final norm
            enc_layer = attn_p + dense_mlp + 2 * d
            cross = attn_p + d
            extra = self.n_enc_layers * enc_layer + self.n_layers * cross \
                + d  # enc_norm
            total += extra
            act_total += extra
        counts["total"] = total
        counts["active"] = act_total
        return counts


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_enabled(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell, and why not if not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> dict:
    _load_all()
    return dict(_REGISTRY)


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in (
        "jamba_1_5_large_398b",
        "phi3_5_moe_42b",
        "granite_moe_3b",
        "llava_next_34b",
        "smollm_360m",
        "mistral_large_123b",
        "h2o_danube3_4b",
        "mistral_nemo_12b",
        "mamba2_2_7b",
        "seamless_m4t_medium",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=max(2, cfg.attn_period or 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=4, top_k=min(2, cfg.moe.top_k), period=cfg.moe.period,
            offset=cfg.moe.offset, capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=16,
                                   n_groups=1, conv_width=4, chunk=32)
    if cfg.attn_period:
        changes["n_layers"] = cfg.attn_period  # one full interleave group
    if cfg.is_encoder_decoder:
        changes["n_enc_layers"] = 2
        changes["n_layers"] = 2
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.n_frontend_tokens:
        changes["n_frontend_tokens"] = 8
    changes["name"] = cfg.name + "-reduced"
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
