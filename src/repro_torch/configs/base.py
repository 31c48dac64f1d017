"""Model configurations, field for field those of the JAX package.

``ModelConfig`` is a frozen dataclass with the JAX package's fields and
defaults, so a config built on either side describes the same model; the
port runs every arch type of the JAX package. The registry maps ``--arch
<id>`` to a config factory; ``smoke_config`` gives the reduced variant of
the same family that the CPU tests run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads

    # attention features
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0   # 0 = full attention; >0 = window size (decode)

    # MLA (deepseek)
    use_mla: bool = False
    mla_absorb: bool = False
    mla_cache_shard: str = "latent"
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    moe_groups: int = 1
    pad_experts_to: int = 0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_checkpoint_chunks: bool = True

    # hybrid (zamba2)
    attn_every: int = 0
    shared_attn_lora_rank: int = 0

    # xlstm
    slstm_every: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_frames: int = 1500

    # vlm
    n_img_tokens: int = 0

    # numerics / runtime
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    use_pallas: bool = False          # True: attention and norms through the kernels
    remat: bool = False
    microbatches: int = 1
    activation_shard: str = "seq"

    @property
    def padded_experts(self) -> int:
        return max(self.n_experts, self.pad_experts_to)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads it."""
        m = 256
        return ((self.vocab_size + m - 1) // m) * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def smoke_config(name: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model 128, 4 heads
    of 32, vocab 512; 4 experts, top-2, expert width 64, at most one
    shared expert and one first dense layer; an MLA latent of 32 with
    nope/rope/v heads of 32/16/32; an SSM state of 16 with heads of 16 and
    chunks of 8, a shared attention every 2 layers with LoRA rank 8, an
    sLSTM every 2 layers, 2 encoder layers over 16 frames and 8 image
    tokens, as the JAX package reduces them."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=0,
        param_dtype="float32",
        remat=False,
        activation_shard="none",
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=2, moe_d_ff=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=32,
                  qk_rope_head_dim=16, v_head_dim=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.attn_every:
        kw.update(attn_every=2, shared_attn_lora_rank=8)
    if cfg.slstm_every:
        kw.update(slstm_every=2)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, enc_frames=16)
    if cfg.n_img_tokens:
        kw.update(n_img_tokens=8)
    return cfg.replace(**kw)
