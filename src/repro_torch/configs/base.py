"""Model configuration: the reference ``ModelConfig`` with every field that
its families (``lstm``, ``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm``,
``audio``) read, ``MoEConfig``, ``SSMConfig``, and the training side's
``L2SConfig`` (Algorithm 1) and ``TrainConfig`` (the LM trainer), field for
field with the reference's defaults, the derived ``q_per_kv``,
``supports_decode`` and ``supports_long_context``, the reference's analytic
``param_count`` / ``active_param_count``, and the dry run's four input
shapes (``ShapeConfig``, ``INPUT_SHAPES``, ``shapes_for``).

``reduced()`` gives the same small CPU variant as the reference, field for
field (``tests/test_torch_ssm.py`` and ``tests/test_torch_vlm.py`` assert
it).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# Vocab block size of the block-candidate screens and of the packed softmax
# head (one CUDA tile of 128 rows).
V_BLK = 128

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "lstm")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # capacity factor of the fixed-shape dispatch (slots per expert =
    # capacity_factor * tokens * top_k / num_experts)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings."""
    state_dim: int = 128          # N: per-channel SSM state size
    head_dim: int = 64            # P: channels per SSD head
    expand: int = 2               # inner dim = expand * d_model
    chunk: int = 256              # SSD chunk length (intra-chunk dual form)
    conv_width: int = 4           # causal depthwise conv width
    n_groups: int = 1             # B/C groups (GVA-style)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio | lstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    mlp_activation: str = "swiglu"          # geglu | swiglu | gelu | relu
    positional: str = "rope"                # rope | mrope | learned | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    sliding_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k mamba layers
    hybrid_shared_period: int = 6
    # encoder-only (audio): no causal mask, no decode
    is_encoder: bool = False
    # vlm: number of vision patch embeddings prepended to the text
    num_patch_tokens: int = 0
    source: str = ""
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads {self.num_heads} not "
                             f"divisible by kv {self.num_kv_heads}")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    def supports_long_context(self) -> bool:
        """True if decode over 500k context is sub-quadratic / bounded-state."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula (norm scales
        counted once a layer, biases not at all)."""
        d, ff, v, nl = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        n = v * d if self.tie_embeddings else 2 * v * d
        if self.family == "lstm":
            return n + nl * 4 * (2 * d + 1) * d
        per_layer_attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                          + self.num_heads * hd * d)
        act_mult = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        per_layer_mlp = act_mult * d * ff
        if self.family == "moe":
            per_layer_mlp = (per_layer_mlp * self.moe.num_experts
                             + d * self.moe.num_experts)       # + router
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            dinner = s.expand * d
            nh = dinner // s.head_dim
            bc = 2 * s.n_groups * s.state_dim
            per_layer_ssm = (d * (2 * dinner + bc + nh) + dinner * d
                             + s.conv_width * (dinner + bc) + 2 * nh)
            n += nl * (per_layer_ssm + 2 * d)
            if self.family == "hybrid":
                n += per_layer_attn + per_layer_mlp + 2 * d
            return n
        return n + nl * (per_layer_attn + per_layer_mlp + 2 * d)

    def active_param_count(self) -> int:
        """Parameters a token uses: for moe, only ``top_k`` experts count."""
        if self.family != "moe":
            return self.param_count()
        act_mult = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        inactive = ((self.moe.num_experts - self.moe.top_k) * act_mult
                    * self.d_model * self.d_ff * self.num_layers)
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Same family, tiny: 2 layers, d_model ≤ 128, vocab ≤ 512, ≤ 4
        experts (the reference's ``ModelConfig.reduced``)."""
        d = min(self.d_model, 128)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads and heads % kv:
            kv -= 1
        kw = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv if heads else 0,
            head_dim=(d // heads) if heads else 16,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            num_patch_tokens=(min(self.num_patch_tokens, 8)
                              if self.num_patch_tokens else 0),
            dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe,
                                num_experts=min(self.moe.num_experts, 4))
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state_dim=min(self.ssm.state_dim, 16),
                                head_dim=16, chunk=16, expand=2)
        if self.family == "hybrid":
            kw["hybrid_shared_period"] = 1
        return replace(self, **kw)


@dataclass(frozen=True)
class L2SConfig:
    """Hyper-parameters of the paper's technique (Algorithm 1)."""
    num_clusters: int = 100          # r
    budget: int = 512                # B: average candidate size (words)
    top_k: int = 5                   # k used to build ground-truth label sets y
    lamb: float = 3e-4               # λ in Eq.(6) — paper value
    gamma: float = 10.0              # γ Lagrange weight — paper value
    outer_iters: int = 4             # T alternating rounds
    sgd_steps: int = 200             # SGD steps per v-update round
    lr: float = 0.05
    gumbel_temp: float = 1.0
    batch_size: int = 512
    # block-candidate variant: items of V_BLK words; block=1 → paper-faithful
    vocab_block: int = 1
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatch: Optional[int] = None   # gradient accumulation (None = off)
    remat: str = "block"               # none | block (a no-op in the port)
    loss_chunk: Optional[int] = 512    # chunked xent (no full B,T,V logits)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the 4 assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the 4 input shapes apply to an architecture: an encoder
    has no decode; long_500k runs dense archs as the dry run's
    sliding-window variant (``launch/dryrun.py::decode_window``)."""
    out = ["train_4k", "prefill_32k"]
    if cfg.supports_decode:
        out.append("decode_32k")
        out.append("long_500k")
    return tuple(out)
