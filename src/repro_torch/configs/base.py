"""Model/run configuration schema shared by all assigned architectures.

A copy of the reference's schema (every field, derived property and
analytic count, value for value); ``compute_dtype``/``param_dtype`` stay
strings and map to ``torch.dtype`` through :func:`torch_dtype`."""

from __future__ import annotations

import dataclasses

import torch

def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``"bfloat16"``, ``"float32"``, ...) as a
    ``torch.dtype``."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    # layer-kind pattern, repeated n_layers // len(unit) times (+ tail)
    # kinds: global | local | cross | moe | ssm | rec
    unit: tuple[str, ...] = ("global",)
    window: int = 4096
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_softcap: float = 0.0  # 0 → off (gemma2: 50.0)
    final_softcap: float = 0.0  # gemma2: 30.0
    tie_embeddings: bool = False
    mlp_gated: bool = True
    act: str = "silu"  # silu | gelu
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_shard_mode: str = "expert"  # expert-parallel vs ffn tensor-parallel
    capacity_factor: float = 1.25
    # SSM (mamba-2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    # RG-LRU (recurrentgemma)
    lru_width: int = 0  # 0 → d_model
    # vlm / audio stubs: cross-attention context length from the frontend
    cross_kv_len: int = 0
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    norm_eps: float = 1e-6
    # unroll the layer scan (dry-run: exact cost_analysis — XLA counts scan
    # bodies once, so scanned models under-report FLOPs/collectives by ~depth)
    unroll_layers: bool = False
    # ---- §Perf hillclimb switches (EXPERIMENTS.md §Perf; default = paper-
    # faithful/naive baseline) ----
    # repeat KV heads to the query-head count before attention: keeps every
    # attention einsum head-aligned with the TP sharding, so GSPMD stops
    # inserting a reshard inside each flash block pair
    opt_attn_layout: bool = False
    # checkpoint the inner flash kv-step: backward recomputes the [bq,bk]
    # probability block instead of saving it per step (flash-style backward)
    opt_flash_remat: bool = False
    # int8 KV cache (serving): halves decode memory traffic vs bf16
    opt_kv_quant: bool = False
    # pad query heads to a TP-divisible count (e.g. 24→32, 40→48 on a 16-way
    # model axis) with zero wq rows / wo cols — numerics exact, stops GSPMD
    # from sharding head_dim (which puts an all-reduce inside every flash
    # block pair)
    pad_heads_to: int = 0
    # flash-attention block sizes: larger bq cuts KV re-streaming (HBM
    # traffic scales with nq = T/bq) at the cost of VMEM per block
    attn_bq: int = 512
    attn_bk: int = 512
    # sharding scheme: "tp" = Megatron-style tensor parallel on the model
    # axis (baseline); "dp_sp" = replicated weights + sequence parallelism
    # over the model axis (the right scheme for small models at prefill —
    # see EXPERIMENTS.md §Perf cell B)
    shard_mode: str = "tp"
    # which shape cells this arch supports (DESIGN.md §6)
    supports_long_context: bool = False

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.unit)

    @property
    def tail(self) -> tuple[str, ...]:
        return self.unit[: self.n_layers % len(self.unit)]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> list[str]:
        return list(self.unit) * self.n_units + list(self.tail)

    # ------------------------------------------------------ analytics
    def param_count(self) -> int:
        """Exact parameter count (embeddings included)."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d  # embed
        if not self.tie_embeddings:
            n += self.vocab * d
        for kind in self.layer_kinds():
            n += self._layer_params(kind)
        n += d  # final norm
        return n

    def _layer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        mlp = d * self.d_ff * (3 if self.mlp_gated else 2)
        norms = 2 * d
        if kind in ("global", "local", "cross"):
            return attn + mlp + norms
        if kind == "moe":
            experts = self.n_experts * d * self.d_ff * 3
            shared = self.n_shared_experts * d * self.d_ff * 3
            router = d * self.n_experts
            return attn + experts + shared + router + norms
        if kind == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D + norm
            zxbcdt = d * (2 * di + 2 * ns + nh)
            return zxbcdt + self.conv_width * (di + 2 * ns) + di * d + 2 * nh + di + d
        if kind == "rec":
            w = self.lru_dim
            # two in-proj branches, conv, RG-LRU gates, out proj + mlp + norms
            return 2 * d * w + self.conv_width * w + 2 * w * w + w + w * d + mlp + 2 * d
        raise ValueError(kind)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.n_experts == 0:
            return self.param_count()
        n = self.param_count()
        d = self.d_model
        inactive = (self.n_experts - self.top_k) * d * self.d_ff * 3
        n -= inactive * sum(1 for k in self.layer_kinds() if k == "moe")
        return n


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) column of the assignment matrix."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict[str, torch.Tensor]:
    """``meta``-device stand-ins for every model input of a cell, with the
    reference's shapes and dtypes (int32 tokens, bf16 cross embeddings, an
    int32 scalar decode position); nothing is allocated."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        specs = {"tokens": spec((B, 1), torch.int32), "position": spec((), torch.int32)}
    else:
        specs = {"tokens": spec((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = spec((B, S), torch.int32)
    if cfg.family == "vlm":
        specs["cross_embeds"] = spec((B, cfg.cross_kv_len, cfg.d_model), torch.bfloat16)
    return specs
