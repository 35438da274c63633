"""Architecture configuration schema + registry.

The port's own copy of ``repro/configs/base.py`` and its ten
architecture files, unchanged but for the package name: pure data, so
both packages size every model alike (``tests/test_torch_models.py``
holds each field equal).

One ``<arch>.py`` per assigned architecture lives next to this file;
each exports ``CONFIG`` (full published size) and ``SMOKE_CONFIG`` (a
reduced same-family config for CPU smoke tests).
``repro_torch.configs.get(name)`` resolves either.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get", "list_archs",
           "smoke", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # layer pattern, cycled over depth. entries: global|local|recurrent|mamba
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 4096              # local-attention window
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"               # silu | gelu | geglu (geglu = gated gelu)
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    first_k_dense: int = 0          # leading dense-FFN layers (deepseek-moe)
    capacity_factor: float = 1.25
    moe_dispatch: str = "sorted"    # sorted (pJDS-style) | onehot (baseline)
    moe_local_shards: int = 0       # >1: sort/dispatch per data shard (vmap)
                                    # so routing never crosses the data axis
    # SSM (mamba1)
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    ssm_scan_chunk: int = 0   # 0 = auto (128; collapsed in cost mode);
                              # >0 = fixed, honoured even in cost mode
    # encoder-decoder
    enc_layers: int = 0
    # modality frontend stub: precomputed embeddings are a model INPUT
    frontend: str | None = None     # vision | audio
    frontend_seq: int = 0           # patches / frames per example
    # paper technique hook: FFN weight density (<1 -> pJDS SparseFFN)
    sparse_ffn_density: float = 1.0
    # §Perf variant: parallel attention+MLP residual block (PaLM-style)
    # -> the two row-parallel partial sums share ONE all-reduce per layer
    parallel_block: bool = False
    # capability flags
    subquadratic: bool = False      # may run long_500k
    # dtypes
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def pattern_at(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = {}
        att = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        mlp_mult = 3 if self.act in ("silu", "geglu") else 2
        dense_mlp = mlp_mult * d * ff
        moe_mlp = (self.n_experts + self.n_shared_experts) * mlp_mult * d * ff \
            + d * self.n_experts
        if self.d_inner:
            mamba = (2 * d * self.d_inner            # in_proj
                     + self.conv_width * self.d_inner
                     + self.d_inner * (max(self.dt_rank, 1) + 2 * self.ssm_state)
                     + max(self.dt_rank, 1) * self.d_inner
                     + self.d_inner * self.ssm_state  # A
                     + self.d_inner * d)              # out_proj
        else:
            mamba = 0
        rec = (3 * d * self.d_inner + self.conv_width * self.d_inner
               + 2 * self.d_inner + self.d_inner * d) if self.d_inner else 0
        total = emb
        n_blocks = self.n_layers + self.enc_layers
        for i in range(n_blocks):
            pat = self.pattern_at(i)
            if pat == "mamba":
                total += mamba
            elif pat == "recurrent":
                total += rec + dense_mlp
            else:
                total += att + (moe_mlp if (self.n_experts and i >= self.first_k_dense)
                                else dense_mlp)
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        mlp_mult = 3 if self.act in ("silu", "geglu") else 2
        full = self.n_params()
        inactive = (self.n_experts - self.top_k) * mlp_mult * d * ff \
            * max(self.n_layers - self.first_k_dense, 0)
        return int(full - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "llava-next-mistral-7b",
    "recurrentgemma-2b",
    "falcon-mamba-7b",
    "granite-moe-3b-a800m",
    "deepseek-moe-16b",
    "gemma3-4b",
    "starcoder2-15b",
    "minicpm-2b",
    "qwen2.5-14b",
    "seamless-m4t-medium",
]


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE_CONFIG


def list_archs():
    return list(ARCH_IDS)
