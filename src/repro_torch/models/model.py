"""Model assembly of the port for every family.

Port of ``repro.models.model``:

  dense / vlm -- decoder-only transformer (GQA, RoPE or M-RoPE, optional
                 qk-norm / qkv-bias), SwiGLU MLP;
  moe         -- the same backbone with a token-choice top-k MoE FFN
                 (+ shared experts);
  ssm         -- Mamba2 (SSD) stack, attention-free;
  hybrid      -- Zamba2-style: a Mamba2 backbone with one *shared-weight*
                 attention+MLP block applied before every group of
                 ``attn_every`` layers (separate KV cache per application);
  encdec      -- encoder-decoder (the Seamless text path): the encoder takes
                 precomputed frame embeddings (the modality frontend is a
                 stub, as in the reference), the decoder attends to itself
                 and, without RoPE, to the encoder's output.

``DecoderLM``, ``SSMModel``, ``HybridModel`` and ``EncDecModel`` expose
``param_specs`` / ``init`` / ``prefill`` / ``decode`` / ``init_cache`` and
the training pair ``hidden`` (``decode_hidden`` for the encoder-decoder)
/ ``loss`` as the reference does, over parameter trees with the reference's keys and
stacked ``[L, ...]`` leaves.  PyTorch runs eagerly, so the reference's
``lax.scan`` over layers is a Python loop, and the caches are written in
place: ``prefill`` into a buffer of ``max_len`` positions (the serving
margin included, instead of concatenating zeros), ``decode`` at position
``cache["len"]`` (a Python int), raising on a full KV cache where the
reference clamps.  ``SSMModel`` has no KV cache: its ``prefill`` takes
``max_len`` and ignores it.  ``kernels`` (a backend name or
``KernelConfig``, resolved against the tokens' device; ``+fused`` has no
meaning here and is ignored) picks the route of the attention (prefill,
the encoder, cross-attention) and of the SSD scan.  ``prefill`` and the
training forward share one layer function per family (``_block``, and
``_group`` for the hybrid), and ``decode`` its FFN half.

Training: ``loss(params, batch)`` returns ``(loss, {"ce", ...})`` as the
reference does: the masked token-mean cross entropy over all
``padded_vocab`` columns, plus ``AUX_COEF`` times the layers' mean MoE
load-balance loss for the decoder family (``{"ce", "aux"}``).  The
reference's ``remat_policy="full"`` (``jax.checkpoint`` of each scanned
layer) is ``torch.utils.checkpoint`` of each layer (a hybrid group, as
there) while a gradient is being taken (:func:`_remat`).  On the ``cuda``
route the gradient of attention runs the hand-written backward kernels;
the SSD scan kernel has none yet, so an SSM or hybrid loss under a
gradient raises there and trains on the ``torch`` route.

Not ported: the ``fsdp_gather`` / ``shard_activation`` constraints
(GSPMD).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import (_mm, attention, attn_out, attn_qkv, attn_specs,
                     cross_entropy, decode_attention, embed, embed_specs,
                     mlp, mlp_specs, moe_ffn, moe_specs, rmsnorm, unembed)
from .module import materialize, spec
from .ssm import mamba2_decode_step, mamba2_forward, mamba2_specs

AUX_COEF = 0.01


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (the reference's ``remat_policy="full"``, the only one the config
    takes) while a gradient is being taken; a plain call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def default_positions(B: int, S: int, device=None):
    return torch.arange(S, device=device).expand(B, S)


def _layers(tree) -> list:
    """Every layer's slice of the stacked ``[L, ...]`` leaves of ``tree``,
    a list of L trees of views, by one ``unbind`` a leaf: under a gradient
    the layers' gradients are stacked once a leaf, where slicing one layer
    at a time would scatter each into a zero tensor of the whole stack."""
    if isinstance(tree, dict):
        per = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[l] for k, v in per.items()} for l in range(n)]
    return list(tree.unbind(0))


def _check_room(cache):
    if int(cache["len"]) >= cache["k"].shape[2]:
        raise ValueError(f"decode: the cache holds {cache['k'].shape[2]} "
                         f"positions, all filled")


class DecoderLM:
    """Decoder-only LM: ``n_layers`` blocks of attention and an MLP (or an
    MoE FFN), pre-norm, over one ``[L, ...]`` stack of layer weights."""

    def __init__(self, cfg: ModelConfig, kernels=None):
        self.cfg = cfg
        self.kernels = kernels

    def param_specs(self):
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        blocks = {
            "ln1": spec((L, d), ("layers", "embed"), dtype=cfg.param_dtype,
                        init="ones"),
            "ln2": spec((L, d), ("layers", "embed"), dtype=cfg.param_dtype,
                        init="ones"),
            "attn": attn_specs(cfg, layers=L),
        }
        if cfg.moe:
            blocks["moe"] = moe_specs(cfg, layers=L)
        else:
            blocks["mlp"] = mlp_specs(d, cfg.d_ff, layers=L,
                                      dtype=cfg.param_dtype)
        return {
            "embed": embed_specs(cfg),
            "blocks": blocks,
            "final_norm": spec((d,), ("embed",), dtype=cfg.param_dtype,
                               init="ones"),
        }

    def layer_specs(self):
        """The specs of one layer's slice of ``blocks``."""
        cfg = self.cfg
        d = cfg.d_model
        ls = {
            "ln1": spec((d,), ("embed",), dtype=cfg.param_dtype, init="ones"),
            "ln2": spec((d,), ("embed",), dtype=cfg.param_dtype, init="ones"),
            "attn": attn_specs(cfg),
        }
        if cfg.moe:
            ls["moe"] = moe_specs(cfg)
        else:
            ls["mlp"] = mlp_specs(d, cfg.d_ff)
        return ls

    def init(self, generator: torch.Generator, device=None):
        return materialize(self.param_specs(), generator, device)

    def _ffn(self, lp, h):
        """The FFN half of a layer: (h + FFN(norm(h)), the MoE aux loss or
        a float32 zero)."""
        cfg = self.cfg
        f_in = rmsnorm(h, lp["ln2"], cfg.norm_eps)
        if cfg.moe:
            y, aux = moe_ffn(lp["moe"], f_in, cfg)
            return h + y, aux
        return (h + mlp(lp["mlp"], f_in, cfg),
                torch.zeros((), dtype=torch.float32, device=h.device))

    def _block(self, lp, h, positions):
        """One layer over the whole sequence: (h, k, v, aux)."""
        cfg = self.cfg
        a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], a_in, cfg, positions)
        o = attention(q, k, v, causal=True, kernels=self.kernels)
        h, aux = self._ffn(lp, h + attn_out(lp["attn"], o, cfg))
        return h, k, v, aux

    def hidden(self, params, tokens, positions):
        """tokens [B, S] -> (final-normed hidden states [B, S, d_model],
        the layers' mean MoE aux loss: a float32 zero for dense)."""
        cfg = self.cfg
        h = embed(params["embed"], tokens, cfg)
        auxs = []
        for lp in _layers(params["blocks"]):
            h, aux = _remat(lambda lp, x: self._block(lp, x, positions)[::3],
                            lp, h)
            auxs.append(aux)
        return (rmsnorm(h, params["final_norm"], cfg.norm_eps),
                torch.stack(auxs).mean())

    def loss(self, params, batch):
        """(ce + AUX_COEF * aux, {"ce", "aux"}) of batch["tokens"] /
        batch["labels"] [B, S] (and ``positions`` under ``mrope``)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        h, aux = self.hidden(params, tokens,
                             self._positions(batch, B, S, tokens.device))
        logits = unembed(params["embed"], h, cfg)
        ce = cross_entropy(logits, labels, cfg.padded_vocab)
        return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}

    def _positions(self, batch, B, S, device):
        if self.cfg.mrope:
            return batch["positions"]                            # [B,S,3]
        pos = batch.get("positions")
        return default_positions(B, S, device) if pos is None else pos

    def prefill(self, params, batch, max_len: int | None = None):
        """batch["tokens"]: [B, S] (and ``positions`` [B, S, 3] under
        ``mrope``) -> (logits [B, 1, V] of the last position, cache with
        k/v of ``max_len`` (default S) positions, S of them filled)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        positions = self._positions(batch, B, S, dev)
        cache = self.init_cache(B, max_len or S, device=dev)
        h = embed(params["embed"], tokens, cfg)
        for l, lp in enumerate(_layers(params["blocks"])):
            h, k, v, _ = self._block(lp, h, positions)
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
        h = rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        cache["len"] = S
        return unembed(params["embed"], h, cfg), cache

    def decode(self, params, cache, batch):
        """batch["token"]: [B, 1] -> (logits [B, 1, V], cache) with the new
        position written in place and ``cache["len"]`` advanced."""
        cfg = self.cfg
        token = batch["token"]
        B = token.shape[0]
        _check_room(cache)
        pos = int(cache["len"])
        dev = token.device
        shape = (B, 1, 3) if cfg.mrope else (B, 1)
        positions = torch.full(shape, pos, dtype=torch.int32, device=dev)
        kv_len = torch.full((B,), pos, dtype=torch.int32, device=dev)
        h = embed(params["embed"], token, cfg)
        for l, lp in enumerate(_layers(params["blocks"])):
            ck, cv = cache["k"][l], cache["v"][l]
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(lp["attn"], a_in, cfg, positions)
            k, v = k.to(ck.dtype), v.to(cv.dtype)
            # the live prefix only: the stale tail would be masked anyway
            o = decode_attention(q, ck[:, :pos], cv[:, :pos], k, v, kv_len)
            h, _ = self._ffn(lp, h + attn_out(lp["attn"], o, cfg))
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        cache["len"] = pos + 1
        return unembed(params["embed"], h, cfg), cache

    def init_cache(self, B: int, max_len: int, device=None):
        cfg = self.cfg
        shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                "len": 0}


class SSMModel:
    """Mamba2 (SSD) stack: ``n_layers`` pre-norm mixers over one
    ``[L, ...]`` stack of layer weights, attention-free."""

    def __init__(self, cfg: ModelConfig, kernels=None):
        self.cfg = cfg
        self.kernels = kernels

    def param_specs(self):
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        return {
            "embed": embed_specs(cfg),
            "blocks": {
                "ln": spec((L, d), ("layers", "embed"),
                           dtype=cfg.param_dtype, init="ones"),
                "mix": mamba2_specs(cfg, layers=L),
            },
            "final_norm": spec((d,), ("embed",), dtype=cfg.param_dtype,
                               init="ones"),
        }

    def init(self, generator: torch.Generator, device=None):
        return materialize(self.param_specs(), generator, device)

    def layer_specs(self):
        """The specs of one layer's slice of ``blocks``."""
        cfg = self.cfg
        return {"ln": spec((cfg.d_model,), ("embed",), init="ones"),
                "mix": mamba2_specs(cfg)}

    def _block(self, lp, h):
        """One layer over the whole sequence: (h, SSM state, conv tail)."""
        y, st, tail = mamba2_forward(
            lp["mix"], rmsnorm(h, lp["ln"], self.cfg.norm_eps), self.cfg,
            kernels=self.kernels)
        return h + y, st, tail

    def hidden(self, params, tokens):
        """tokens [B, S] -> final-normed hidden states [B, S, d_model]."""
        cfg = self.cfg
        h = embed(params["embed"], tokens, cfg)
        for lp in _layers(params["blocks"]):
            h = _remat(lambda lp, x: self._block(lp, x)[0], lp, h)
        return rmsnorm(h, params["final_norm"], cfg.norm_eps)

    def loss(self, params, batch):
        """(ce, {"ce"}) of batch["tokens"] / batch["labels"] [B, S]."""
        cfg = self.cfg
        h = self.hidden(params, batch["tokens"])
        logits = unembed(params["embed"], h, cfg)
        ce = cross_entropy(logits, batch["labels"], cfg.padded_vocab)
        return ce, {"ce": ce}

    def prefill(self, params, batch, max_len: int | None = None):
        """batch["tokens"]: [B, S] -> (logits [B, 1, V] of the last position,
        cache with each layer's SSM state and conv tail).  ``max_len`` is
        taken and ignored: the cache does not grow with the sequence."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = self.init_cache(B, device=tokens.device)
        h = embed(params["embed"], tokens, cfg)
        for l, lp in enumerate(_layers(params["blocks"])):
            h, st, tail = self._block(lp, h)
            cache["ssm"][l] = st
            cache["conv"][l] = tail
        h = rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        cache["len"] = S
        return unembed(params["embed"], h, cfg), cache

    def decode(self, params, cache, batch):
        """batch["token"]: [B, 1] -> (logits [B, 1, V], cache) with the
        states advanced in place; no KV cache, so no room to run out of."""
        cfg = self.cfg
        h = embed(params["embed"], batch["token"], cfg)
        for l, lp in enumerate(_layers(params["blocks"])):
            y, st, conv = mamba2_decode_step(
                lp["mix"], rmsnorm(h, lp["ln"], cfg.norm_eps), cfg,
                cache["ssm"][l], cache["conv"][l])
            h = h + y
            cache["ssm"][l] = st
            cache["conv"][l] = conv
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        cache["len"] = int(cache["len"]) + 1
        return unembed(params["embed"], h, cfg), cache

    def init_cache(self, B: int, max_len: int = 0, device=None):
        cfg = self.cfg
        convc = cfg.d_inner + 2 * cfg.d_state
        return {
            "ssm": torch.zeros((cfg.n_layers, B, cfg.ssm_heads, cfg.headdim,
                                cfg.d_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((cfg.n_layers, B, cfg.d_conv - 1, convc),
                                dtype=cfg.compute_dtype, device=device),
            "len": 0,
        }


class HybridModel:
    def __init__(self, cfg: ModelConfig, kernels=None):
        assert cfg.n_layers % cfg.attn_every == 0
        self.cfg = cfg
        self.kernels = kernels
        self.n_groups = cfg.n_layers // cfg.attn_every

    def param_specs(self):
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        return {
            "embed": embed_specs(cfg),
            "mamba": {
                "ln": spec((L, d), ("layers", "embed"),
                           dtype=cfg.param_dtype, init="ones"),
                "mix": mamba2_specs(cfg, layers=L),
            },
            "shared": {
                "ln1": spec((d,), ("embed",), dtype=cfg.param_dtype,
                            init="ones"),
                "attn": attn_specs(cfg),
                "ln2": spec((d,), ("embed",), dtype=cfg.param_dtype,
                            init="ones"),
                "mlp": mlp_specs(d, cfg.d_ff, dtype=cfg.param_dtype),
            },
            "final_norm": spec((d,), ("embed",), dtype=cfg.param_dtype,
                               init="ones"),
        }

    def init(self, generator: torch.Generator, device=None):
        return materialize(self.param_specs(), generator, device)

    def _shared_block(self, sp, h, o):
        cfg = self.cfg
        h = h + attn_out(sp["attn"], o, cfg)
        return h + mlp(sp["mlp"], rmsnorm(h, sp["ln2"], cfg.norm_eps), cfg)

    def _group(self, sp, mamba_layers, h, positions):
        """One group over the whole sequence: the shared attention block
        (``sp``), then its ``attn_every`` mamba layers (trees of one
        layer's leaves).  Returns (h, k, v, [(SSM state, conv tail) of
        each mamba layer])."""
        cfg = self.cfg
        a_in = rmsnorm(h, sp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(sp["attn"], a_in, cfg, positions)
        o = attention(q, k, v, causal=True, kernels=self.kernels)
        h = self._shared_block(sp, h, o)
        states = []
        for lp in mamba_layers:
            y, st, tail = mamba2_forward(
                lp["mix"], rmsnorm(h, lp["ln"], cfg.norm_eps), cfg,
                kernels=self.kernels)
            h = h + y
            states.append((st, tail))
        return h, k, v, states

    def hidden(self, params, tokens, positions):
        """tokens [B, S] -> final-normed hidden states [B, S, d_model];
        each group is rematerialized as one, as in the reference."""
        cfg = self.cfg
        h = embed(params["embed"], tokens, cfg)
        layers, E = _layers(params["mamba"]), cfg.attn_every
        for g in range(self.n_groups):
            h = _remat(lambda x, ls: self._group(params["shared"], ls, x,
                                                 positions)[0],
                       h, layers[g * E:(g + 1) * E])
        return rmsnorm(h, params["final_norm"], cfg.norm_eps)

    def loss(self, params, batch):
        """(ce, {"ce"}) of batch["tokens"] / batch["labels"] [B, S]."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = self.hidden(params, tokens,
                        default_positions(B, S, tokens.device))
        logits = unembed(params["embed"], h, cfg)
        ce = cross_entropy(logits, batch["labels"], cfg.padded_vocab)
        return ce, {"ce": ce}

    def prefill(self, params, batch, max_len: int | None = None):
        """batch["tokens"]: [B, S] -> (logits [B, 1, V] of the last position,
        cache with k/v of ``max_len`` (default S) positions, S of them
        filled)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        positions = default_positions(B, S, device=dev)
        cache = self.init_cache(B, max_len or S, device=dev)
        h = embed(params["embed"], tokens, cfg)
        layers, E = _layers(params["mamba"]), cfg.attn_every
        for g in range(self.n_groups):
            h, k, v, states = self._group(params["shared"],
                                          layers[g * E:(g + 1) * E], h,
                                          positions)
            cache["k"][g, :, :S] = k
            cache["v"][g, :, :S] = v
            for l, (st, tail) in enumerate(states, start=g * E):
                cache["ssm"][l] = st
                cache["conv"][l] = tail
        h = rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        cache["len"] = S
        return unembed(params["embed"], h, cfg), cache

    def decode(self, params, cache, batch):
        """batch["token"]: [B, 1] -> (logits [B, 1, V], cache) with the new
        position written in place and ``cache["len"]`` advanced."""
        cfg = self.cfg
        token = batch["token"]
        B = token.shape[0]
        _check_room(cache)
        pos = int(cache["len"])
        dev = token.device
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        kv_len = torch.full((B,), pos, dtype=torch.int32, device=dev)
        sp = params["shared"]
        h = embed(params["embed"], token, cfg)
        layers, E = _layers(params["mamba"]), cfg.attn_every
        for g in range(self.n_groups):
            ck, cv = cache["k"][g], cache["v"][g]
            a_in = rmsnorm(h, sp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(sp["attn"], a_in, cfg, positions)
            k, v = k.to(ck.dtype), v.to(cv.dtype)
            # the live prefix only: the stale tail would be masked anyway
            o = decode_attention(q, ck[:, :pos], cv[:, :pos], k, v, kv_len)
            h = self._shared_block(sp, h, o)
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
            for l in range(g * E, (g + 1) * E):
                lp = layers[l]
                y, st, conv = mamba2_decode_step(
                    lp["mix"], rmsnorm(h, lp["ln"], cfg.norm_eps), cfg,
                    cache["ssm"][l], cache["conv"][l])
                h = h + y
                cache["ssm"][l] = st
                cache["conv"][l] = conv
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        cache["len"] = pos + 1
        return unembed(params["embed"], h, cfg), cache

    def init_cache(self, B: int, max_len: int, device=None):
        cfg = self.cfg
        G = self.n_groups
        convc = cfg.d_inner + 2 * cfg.d_state
        kv = (G, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
        return {
            "k": z(kv, cfg.compute_dtype),
            "v": z(kv, cfg.compute_dtype),
            "ssm": z((cfg.n_layers, B, cfg.ssm_heads, cfg.headdim,
                      cfg.d_state), torch.float32),
            "conv": z((cfg.n_layers, B, cfg.d_conv - 1, convc),
                      cfg.compute_dtype),
            "len": 0,
        }


class EncDecModel:
    """Encoder-decoder (the Seamless text path): ``n_enc_layers`` encoder
    blocks (RoPE, non-causal self-attention) over precomputed frame
    embeddings, then ``n_layers`` decoder blocks of causal self-attention,
    cross-attention to the encoder's output (no bias, no norm, no RoPE on
    its projections) and an MLP; RMSNorm throughout, as in the reference."""

    def __init__(self, cfg: ModelConfig, kernels=None):
        self.cfg = cfg
        self.kernels = kernels

    def _norms(self, names, L=None):
        cfg = self.cfg
        shape, axes = ((L, cfg.d_model), ("layers", "embed")) if L else (
            (cfg.d_model,), ("embed",))
        return {n: spec(shape, axes, dtype=cfg.param_dtype, init="ones")
                for n in names}

    def param_specs(self):
        cfg = self.cfg
        d = cfg.d_model
        Le, Ld = cfg.n_enc_layers, cfg.n_layers
        return {
            "embed": embed_specs(cfg),
            "enc": {**self._norms(("ln1", "ln2"), Le),
                    "attn": attn_specs(cfg, layers=Le),
                    "mlp": mlp_specs(d, cfg.d_ff, layers=Le,
                                     dtype=cfg.param_dtype)},
            "enc_norm": spec((d,), ("embed",), dtype=cfg.param_dtype,
                             init="ones"),
            "dec": {**self._norms(("ln1", "ln2", "ln3"), Ld),
                    "attn": attn_specs(cfg, layers=Ld),
                    "xattn": attn_specs(cfg, layers=Ld),
                    "mlp": mlp_specs(d, cfg.d_ff, layers=Ld,
                                     dtype=cfg.param_dtype)},
            "final_norm": spec((d,), ("embed",), dtype=cfg.param_dtype,
                               init="ones"),
        }

    def init(self, generator: torch.Generator, device=None):
        return materialize(self.param_specs(), generator, device)

    def enc_layer_specs(self):
        """The specs of one layer's slice of ``enc``."""
        cfg = self.cfg
        return {**self._norms(("ln1", "ln2")), "attn": attn_specs(cfg),
                "mlp": mlp_specs(cfg.d_model, cfg.d_ff,
                                 dtype=cfg.param_dtype)}

    def dec_layer_specs(self):
        """The specs of one layer's slice of ``dec``."""
        cfg = self.cfg
        return {**self._norms(("ln1", "ln2", "ln3")), "attn": attn_specs(cfg),
                "xattn": attn_specs(cfg),
                "mlp": mlp_specs(cfg.d_model, cfg.d_ff,
                                 dtype=cfg.param_dtype)}

    def encode(self, params, enc_embeds):
        """enc_embeds [B, S_src, d_model] -> the encoder's output
        [B, S_src, d_model] in ``compute_dtype``."""
        cfg = self.cfg
        B, S, _ = enc_embeds.shape
        positions = default_positions(B, S, enc_embeds.device)
        h = enc_embeds.to(cfg.compute_dtype)
        for lp in _layers(params["enc"]):
            h = _remat(lambda lp, x: self._enc_block(lp, x, positions),
                       lp, h)
        return rmsnorm(h, params["enc_norm"], cfg.norm_eps)

    def _enc_block(self, lp, h, positions):
        """One encoder layer: non-causal self-attention, then the MLP."""
        cfg = self.cfg
        a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], a_in, cfg, positions)
        o = attention(q, k, v, causal=False, kernels=self.kernels)
        h = h + attn_out(lp["attn"], o, cfg)
        return h + mlp(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg)

    def _cross_kv(self, lp, enc_out):
        cfg = self.cfg
        B, S, _ = enc_out.shape
        k = _mm(enc_out, lp["wk"], cfg.compute_dtype)
        v = _mm(enc_out, lp["wv"], cfg.compute_dtype)
        return (k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
                v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))

    def _cross_q(self, lp, x):
        cfg = self.cfg
        B, S, _ = x.shape
        q = _mm(x, lp["wq"], cfg.compute_dtype)
        return q.reshape(B, S, cfg.n_heads, cfg.head_dim)

    def _cross_mlp(self, lp, h, ck, cv):
        """A decoder layer after its self-attention: cross-attention of the
        rows of h to the encoder's k/v (non-causal), then the MLP."""
        cfg = self.cfg
        xq = self._cross_q(lp["xattn"], rmsnorm(h, lp["ln2"], cfg.norm_eps))
        xo = attention(xq, ck, cv, causal=False, kernels=self.kernels)
        h = h + attn_out(lp["xattn"], xo, cfg)
        return h + mlp(lp["mlp"], rmsnorm(h, lp["ln3"], cfg.norm_eps), cfg)

    def _dec_block(self, lp, h, enc_out, positions):
        """One decoder layer over the whole prompt: (h, k, v, cross k,
        cross v)."""
        cfg = self.cfg
        a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], a_in, cfg, positions)
        o = attention(q, k, v, causal=True, kernels=self.kernels)
        h = h + attn_out(lp["attn"], o, cfg)
        ck, cv = self._cross_kv(lp["xattn"], enc_out)
        return self._cross_mlp(lp, h, ck, cv), k, v, ck, cv

    def decode_hidden(self, params, tokens, enc_out, positions):
        """tokens [B, S] over the encoder's output -> final-normed decoder
        hidden states [B, S, d_model]."""
        cfg = self.cfg
        h = embed(params["embed"], tokens, cfg)
        for lp in _layers(params["dec"]):
            h = _remat(
                lambda lp, x: self._dec_block(lp, x, enc_out, positions)[0],
                lp, h)
        return rmsnorm(h, params["final_norm"], cfg.norm_eps)

    def loss(self, params, batch):
        """(ce, {"ce"}) of batch["tokens"] / batch["labels"] [B, S] over
        batch["enc_embeds"] [B, S_src, d_model]."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        enc_out = self.encode(params, batch["enc_embeds"])
        h = self.decode_hidden(params, tokens, enc_out,
                               default_positions(B, S, tokens.device))
        logits = unembed(params["embed"], h, cfg)
        ce = cross_entropy(logits, labels, cfg.padded_vocab)
        return ce, {"ce": ce}

    def prefill(self, params, batch, max_len: int | None = None):
        """batch["tokens"]: [B, S] decoder prompt, batch["enc_embeds"]:
        [B, S_src, d_model] -> (logits [B, 1, V] of the last position, cache
        with the decoder's k/v of ``max_len`` (default S) positions, S of
        them filled, and the cross-attention k/v ``ck``/``cv`` of the S_src
        encoder positions)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        positions = default_positions(B, S, dev)
        enc_out = self.encode(params, batch["enc_embeds"])
        cache = self.init_cache(B, max_len or S, enc_out.shape[1], device=dev)
        h = embed(params["embed"], tokens, cfg)
        for l, lp in enumerate(_layers(params["dec"])):
            h, k, v, ck, cv = self._dec_block(lp, h, enc_out, positions)
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
            cache["ck"][l] = ck
            cache["cv"][l] = cv
        h = rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        cache["len"] = S
        return unembed(params["embed"], h, cfg), cache

    def decode(self, params, cache, batch):
        """batch["token"]: [B, 1] -> (logits [B, 1, V], cache) with the new
        position written in place and ``cache["len"]`` advanced; the
        cross-attention k/v are read only."""
        cfg = self.cfg
        token = batch["token"]
        B = token.shape[0]
        _check_room(cache)
        pos = int(cache["len"])
        dev = token.device
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        kv_len = torch.full((B,), pos, dtype=torch.int32, device=dev)
        h = embed(params["embed"], token, cfg)
        for l, lp in enumerate(_layers(params["dec"])):
            ck, cv = cache["k"][l], cache["v"][l]
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(lp["attn"], a_in, cfg, positions)
            k, v = k.to(ck.dtype), v.to(cv.dtype)
            # the live prefix only: the stale tail would be masked anyway
            o = decode_attention(q, ck[:, :pos], cv[:, :pos], k, v, kv_len)
            h = h + attn_out(lp["attn"], o, cfg)
            h = self._cross_mlp(lp, h, cache["ck"][l], cache["cv"][l])
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        cache["len"] = pos + 1
        return unembed(params["embed"], h, cfg), cache

    def init_cache(self, B: int, max_len: int, src_len: int, device=None):
        cfg = self.cfg
        kd = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        xd = (cfg.n_layers, B, src_len, cfg.n_kv_heads, cfg.head_dim)
        z = lambda shape: torch.zeros(shape, dtype=cfg.compute_dtype,
                                      device=device)
        return {"k": z(kd), "v": z(kd), "ck": z(xd), "cv": z(xd), "len": 0}


def build(cfg: ModelConfig, kernels=None):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, kernels)
    if cfg.family == "ssm":
        return SSMModel(cfg, kernels)
    if cfg.family == "hybrid":
        return HybridModel(cfg, kernels)
    if cfg.family == "encdec":
        return EncDecModel(cfg, kernels)
    raise ValueError(f"unknown family {cfg.family}")
