"""Public model API: ``build_model(cfg)`` -> :class:`Model`.

Port of ``repro/models/api.py``: one class serves the ten architectures
-- decoder-only LMs (dense, MoE, SSM, hybrid), the VLM (llava: the
precomputed patch embeddings ``batch["frontend"]`` prepended to the
text, positions running on over them) and the encoder-decoder
(seamless: the precomputed frame embeddings ``batch["enc_frames"]``
through a bidirectional encoder and ``enc_ln``, which the decoder
cross-attends) -- through ``init``, ``loss``, ``prefill``,
``decode_step`` and ``init_cache``.  ``loss`` is the training forward:
the mean next-token cross-entropy over the text positions
(``transformer.chunked_xent``) plus the weighted MoE auxiliary loss,
differentiable in the params once their ``requires_grad`` is on
(``train.optimizer.AdamW.init`` switches it on).

The model lives on one device: CUDA unless ``device="cpu"`` is given,
and with neither it raises.  Params are the tree of ``nn.ModuleDict`` /
``nn.ParameterDict`` that :meth:`Model.init` builds or
``convert.model_params`` carries across from the reference; the decode
cache is a list of per-layer caches (ring buffers, cross keys and
values, recurrent states) that :meth:`decode_step` updates in place.
Logits are float32, the padded vocab tail masked to -1e30, as the
reference computes them.

Across cards (ROADMAP 1.28) the same entry points take params that are
DTensors over a ``DeviceMesh`` (``train.step.init_sharded`` or
``train.step.shard_params``) and batches laid out by
``train.step.place_batch``, with the logical rules installed
(``models.sharding.use_rules``); activations are constrained where the
reference constrains them.  :meth:`Model.param_specs`,
:meth:`Model.cache_specs` and :meth:`Model.input_specs` give the
reference's logical specs, each from the code that builds its tensors;
:meth:`Model.param_shapes` builds the params on the ``meta`` device.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import SHAPES
from repro_torch.kernels._backend import resolve_device

from . import blocks as B
from . import common as C
from . import transformer as T
from .sharding import is_dtensor, shard, sharded_region

__all__ = ["FAMILIES", "Model", "build_model"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class Model:
    def __init__(self, cfg, device=None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = C.dtype_of(cfg.param_dtype)
        self.adt = C.dtype_of(cfg.activation_dtype)
        self.plan = T.make_plan(cfg, cfg.n_layers)
        self.enc_plan = (T.make_plan(cfg, cfg.enc_layers,
                                     force_dense_pattern=True, moe_ok=False)
                         if cfg.is_encdec else None)
        kinds = T.layer_kinds(self.plan)
        if self.enc_plan:
            kinds += T.layer_kinds(self.enc_plan)
        for kind, _ in kinds:
            B.check_kind(cfg, kind)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> nn.ModuleDict:
        """Random params drawn from ``generator``, which must live on the
        model's device."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"the generator is on {generator.device}; "
                             f"the model on {self.device}")
        return self.build(generator)

    def build(self, gen) -> nn.ModuleDict:
        """The params drawn from ``gen`` (a generator, or a
        ``common.NoDraw`` for shapes only) in the one fixed order."""
        cfg = self.cfg
        p = nn.ModuleDict({"embed": C.embed_init(gen, cfg.vocab, cfg.d_model,
                                                 self.dtype)})
        if not cfg.tie_embeddings:
            p["unembed"] = C.embed_init(gen, cfg.vocab, cfg.d_model,
                                        self.dtype)
        p["final_ln"] = C.rmsnorm_init(cfg.d_model, self.dtype, gen.device)
        p["dec"] = T.stack_init(gen, cfg, self.plan, cross=cfg.is_encdec,
                                dtype=self.dtype)
        if cfg.is_encdec:
            p["enc"] = T.stack_init(gen, cfg, self.enc_plan,
                                    dtype=self.dtype)
            p["enc_ln"] = C.rmsnorm_init(cfg.d_model, self.dtype,
                                         gen.device)
        return p

    def param_shapes(self) -> nn.ModuleDict:
        """The params built on the ``meta`` device: shapes, dtypes and
        ``logical_axes``, no storage."""
        return self.build(C.NoDraw("meta"))

    def param_specs(self) -> dict:
        """Each param's logical axes, keyed by its name in
        ``named_parameters()`` (the names ``convert.model_params``
        gives), from the same init code as the param."""
        return {n: p.logical_axes
                for n, p in self.param_shapes().named_parameters()}

    def _unembed_w(self, params) -> torch.Tensor:
        return params["embed"]["w"] if self.cfg.tie_embeddings \
            else params["unembed"]["w"]

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        if is_dtensor(a):
            return a if dtype is None else a.to(dtype)
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _embed(self, params, tokens) -> torch.Tensor:
        tokens = self._tensor(tokens).long()
        x = C.embed(params["embed"]["w"], tokens, self.adt)
        return shard(x, "batch", None, None)

    # --------------------------------------------------------------- train
    def loss(self, params, batch, *, remat: bool = True, q_chunk: int = 512,
             k_chunk: int = 512, loss_chunk: int = 512,
             aux_weight: float = 1e-2):
        """batch: ``tokens`` and ``labels`` (B, S) integer (label -1
        masked), with ``enc_frames`` (B, Se, D) for an encoder-decoder
        and ``frontend`` (B, F, D) for a VLM, whose positions are not
        scored.  Returns (nll + aux_weight * aux, {"nll", "aux"}), float32
        scalars on the model's device (DTensors, replicated, over a
        mesh)."""
        with sharded_region(params):
            return self._loss(params, batch, remat=remat, q_chunk=q_chunk,
                              k_chunk=k_chunk, loss_chunk=loss_chunk,
                              aux_weight=aux_weight)

    def _loss(self, params, batch, *, remat, q_chunk, k_chunk, loss_chunk,
              aux_weight):
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        memory = None
        if cfg.is_encdec:
            m = shard(self._tensor(batch["enc_frames"]).to(self.adt),
                      "batch", None, None)
            mpos = torch.arange(m.shape[1], device=self.device)[None, :]
            m, _ = T.stack_apply_train(params["enc"], cfg, self.enc_plan, m,
                                       mpos, causal=False, remat=remat,
                                       q_chunk=q_chunk, k_chunk=k_chunk)
            memory = C.rmsnorm(params["enc_ln"], m, cfg.norm_eps)
        n_front = 0
        if cfg.frontend == "vision":
            fe = self._tensor(batch["frontend"]).to(self.adt)
            x = torch.cat([shard(fe, "batch", None, None), x], dim=1)
            n_front = fe.shape[1]
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, aux = T.stack_apply_train(params["dec"], cfg, self.plan, x,
                                     positions, memory=memory, remat=remat,
                                     q_chunk=q_chunk, k_chunk=k_chunk)
        x = C.rmsnorm(params["final_ln"], x, cfg.norm_eps)
        nll = T.chunked_xent(x[:, n_front:], self._unembed_w(params),
                             self._tensor(batch["labels"]),
                             chunk=loss_chunk, vocab=cfg.vocab)
        return nll + aux_weight * aux, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, batch, *, max_len: int, q_chunk: int = 512,
                k_chunk: int = 512):
        """Process the full prompt ``batch["tokens"]`` (B, S), with
        ``batch["enc_frames"]`` (B, Se, D) for an encoder-decoder and
        ``batch["frontend"]`` (B, F, D) for a VLM; returns (cache,
        last-position logits (B, 1, V_pad))."""
        with sharded_region(params):
            return self._prefill(params, batch, max_len=max_len,
                                 q_chunk=q_chunk, k_chunk=k_chunk)

    def _prefill(self, params, batch, *, max_len, q_chunk, k_chunk):
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        memory = None
        if cfg.is_encdec:
            m = self._tensor(batch["enc_frames"]).to(self.adt)
            mpos = torch.arange(m.shape[1], device=self.device)[None, :]
            m, _ = T.stack_apply_train(params["enc"], cfg, self.enc_plan, m,
                                       mpos, causal=False, remat=False,
                                       q_chunk=q_chunk, k_chunk=k_chunk)
            memory = C.rmsnorm(params["enc_ln"], m, cfg.norm_eps)
        if cfg.frontend == "vision":
            fe = self._tensor(batch["frontend"]).to(self.adt)
            x = torch.cat([shard(fe, "batch", None, None), x], dim=1)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, cache = T.stack_apply_prefill(params["dec"], cfg, self.plan, x,
                                         positions, max_len=max_len,
                                         memory=memory, cache_dtype=self.adt,
                                         q_chunk=q_chunk, k_chunk=k_chunk)
        x = C.rmsnorm(params["final_ln"], x[:, -1:], cfg.norm_eps)
        return cache, self._logits(params, x)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        w = self._unembed_w(params)
        logits = torch.einsum("btd,vd->btv", x.float(), w.float())
        if w.shape[0] > self.cfg.vocab:   # mask the padded vocab tail
            logits = logits.masked_fill(
                torch.arange(w.shape[0], device=self.device)
                >= self.cfg.vocab, -1e30)
        return logits

    @torch.no_grad()
    def decode_step(self, params, cache: list, tokens, pos):
        """tokens (B, 1) int, pos (B,) absolute positions.  Writes each
        layer's new k / v into ``cache`` in place; returns (cache,
        logits (B, 1, V_pad))."""
        with sharded_region(params):
            x = self._embed(params, tokens)
            pos = self._tensor(pos, torch.int32)
            x, cache = T.stack_apply_decode(params["dec"], self.cfg,
                                            self.plan, x, cache, pos)
            x = C.rmsnorm(params["final_ln"], x, self.cfg.norm_eps)
            return cache, self._logits(params, x)

    def init_cache(self, batch: int, max_len: int, device=None) -> list:
        return T.stack_cache_init(self.cfg, self.plan, batch, max_len,
                                  cross=self.cfg.is_encdec, dtype=self.adt,
                                  device=device or self.device)

    def cache_specs(self) -> list:
        """Logical specs of :meth:`init_cache`'s caches, one per layer."""
        return T.stack_cache_specs(self.cfg, self.plan,
                                   cross=self.cfg.is_encdec)

    # -------------------------------------------------------- dry-run specs
    def input_specs(self, shape, *, seq_override=None, batch_override=None,
                    device="meta"):
        """(stand-ins, logical specs) for every input of the step the
        shape exercises -- kind ``train``: ``loss(params, batch)``;
        ``prefill``: ``prefill(params, batch)``; ``decode``:
        ``decode_step(params, cache, tokens, pos)`` on a cache of the
        shape's length -- as the reference's.  The stand-ins are empty
        tensors on ``device`` (``meta``: no storage)."""
        cfg = self.cfg
        if isinstance(shape, str):
            shape = SHAPES[shape]
        s = seq_override or shape.seq_len
        b = batch_override or shape.global_batch

        def empty(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device=device)

        if shape.kind in ("train", "prefill"):
            text = s - (cfg.frontend_seq if cfg.frontend == "vision" else 0)
            batch = {"tokens": empty(b, text)}
            specs = {"tokens": ("batch", None)}
            if shape.kind == "train":
                batch["labels"] = empty(b, text)
                specs["labels"] = ("batch", None)
            if cfg.frontend == "vision":
                batch["frontend"] = empty(b, cfg.frontend_seq, cfg.d_model,
                                          dtype=self.adt)
                specs["frontend"] = ("batch", None, None)
            if cfg.is_encdec:
                batch["enc_frames"] = empty(b, s, cfg.d_model,
                                            dtype=self.adt)
                specs["enc_frames"] = ("batch", None, None)
            return batch, specs
        # decode: a cache of length s plus one new token
        batch = {"cache": self.init_cache(b, s, device=device),
                 "tokens": empty(b, 1), "pos": empty(b)}
        specs = {"cache": self.cache_specs(), "tokens": ("batch", None),
                 "pos": ("batch",)}
        return batch, specs


def build_model(cfg, device=None) -> Model:
    return Model(cfg, device=device)
