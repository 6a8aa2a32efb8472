"""Weight bridge: the JAX package's parameter trees -> the port's state_dicts.

Input is the JAX package's parameters as nested dicts of numpy arrays
(``jax.device_get`` of a flax params tree, or an orbax checkpoint restored
to numpy); output is a ``state_dict`` of f32 torch tensors whose keys are
the reference PyTorch layout — the layout the port's modules are named
after, so ``load_state_dict(..., strict=True)`` takes it as it is.

Layout changes:
- flax Conv ``kernel`` (kh, kw, I, O)  -> ``Conv2d.weight`` (O, I, kh, kw)
- flax Dense ``kernel`` (in, out)      -> ``Linear.weight`` (out, in)
- flax BatchNorm scale/bias + batch_stats mean/var -> BN weight/bias/
  running_mean/running_var (+ a zero ``num_batches_tracked``)
- VQ codebook (L, K, D)                -> ``vq.embedding`` (L, K, D)
- flax's auto-named dense stack (``LayerNorm_{2i}``, ``DenseAttention_{i}``,
  ``LayerNorm_{2i+1}``, ``FeedForward_{i}``) -> ``transformer.layers.{i}``

The SOM-DDPM's models: ``som_tokenizer_state_from_state`` (the SOM
autoencoder's convs, BatchNorm statistics and ``SomState``) and
``unet_state_dict_from_params`` (the UNet and ``SimpleDiffusionModel``,
flax's auto-named layers to the port's lists of them).

The two VQ statistics outside the reference layout (``activation_count``,
``accumulated_error``) go beside the state_dict: ``tokenizer_vq_stats``.
``tokenizer_checkpoint_from_state`` writes a JAX tokenizer's arrays (its
whole ``VQState``) as a port tokenizer checkpoint (``train/checkpoint.py``
format, config embedded), which ``cli.train_vqae.load_tokenizer`` reads
and ``cli.train_vqae`` resumes training from.

``param_key_map`` reads any of these converters' key mapping back: which
JAX leaf each state_dict entry comes from, and how its axes were permuted
(the tensor-parallel rules of ``parallel.mesh`` are held to JAX's leaf by
leaf through it).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    # a copy: the source may be a read-only view of a device buffer
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, key: str, p: Mapping, s: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _linear(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _layernorm(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def video_state_dict_from_params(params: Mapping[str, Any]) -> StateDict:
    """JAX ``VqVideoDiffusionModel`` params -> ``models.video.
    VqVideoDiffusionModel`` state_dict."""
    tr = params["transformer"]
    sd: StateDict = {}
    for name in ("embedding", "pos_emb_s", "pos_emb_h", "pos_emb_w"):
        sd[f"transformer.{name}.weight"] = _t(tr[name]["embedding"])
    i = 0
    while f"attn_norm_{i}" in tr:
        base = f"transformer.layers.{i}"
        _layernorm(sd, f"{base}.0.norm", tr[f"attn_norm_{i}"])
        attn = tr[f"attn_{i}"]
        for proj in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{base}.0.fn.{proj}", attn[proj])
        if "to_out" in attn:
            _linear(sd, f"{base}.0.fn.to_out.0", attn["to_out"])
        _layernorm(sd, f"{base}.1.norm", tr[f"ff_norm_{i}"])
        _linear(sd, f"{base}.1.fn.net.0", tr[f"ff_{i}"]["Dense_0"])
        _linear(sd, f"{base}.1.fn.net.3", tr[f"ff_{i}"]["Dense_1"])
        i += 1
    if i == 0:
        raise KeyError("no attn_norm_* layers in params['transformer']")
    _linear(sd, "logit_proj", params["logit_proj"])
    return sd


def sparse_state_dict_from_params(params: Mapping[str, Any]) -> StateDict:
    """JAX ``VqSparseDiffusionModel`` params -> ``models.video.
    VqSparseDiffusionModel`` state_dict (the inverse of the JAX package's
    ``utils/torch_import.py:sparse_params_from_torch``). flax names the
    dense stack's modules in creation order: layer i is ``LayerNorm_{2i}``,
    ``DenseAttention_{i}``, ``LayerNorm_{2i+1}``, ``FeedForward_{i}`` or,
    with mixture-of-experts FFNs, ``MoEFeedForward_{i}``, whose ``w_gate``,
    ``w_in``, ``b_in``, ``w_out`` and ``b_out`` keep their layout
    (``layers.{i}.1.fn.w_gate`` ...). (The JAX package's importer reads no
    MoE keys.)"""
    tr = params["transformer"]
    sd: StateDict = {}
    for name in ("pos_emb_s", "pos_emb_h", "pos_emb_w", "embedding"):
        sd[f"{name}.weight"] = _t(params[name]["embedding"])
    i = 0
    while f"DenseAttention_{i}" in tr:
        base = f"transformer.layers.{i}"
        _layernorm(sd, f"{base}.0.norm", tr[f"LayerNorm_{2 * i}"])
        attn = tr[f"DenseAttention_{i}"]
        _linear(sd, f"{base}.0.fn.to_qkv", attn["to_qkv"])
        if "to_out" in attn:
            _linear(sd, f"{base}.0.fn.to_out.0", attn["to_out"])
        _layernorm(sd, f"{base}.1.norm", tr[f"LayerNorm_{2 * i + 1}"])
        if f"MoEFeedForward_{i}" in tr:
            for name, w in tr[f"MoEFeedForward_{i}"].items():
                sd[f"{base}.1.fn.{name}"] = _t(w)
        else:
            _linear(sd, f"{base}.1.fn.net.0", tr[f"FeedForward_{i}"]["Dense_0"])
            _linear(sd, f"{base}.1.fn.net.3", tr[f"FeedForward_{i}"]["Dense_1"])
        i += 1
    if i == 0:
        raise KeyError("no DenseAttention_* layers in params['transformer']")
    _linear(sd, "logit_proj", params["logit_proj"])
    return sd


def _residual(sd: StateDict, base: str, p: Mapping, s: Mapping) -> None:
    _conv(sd, f"{base}._block.0", p["Conv_0"])
    _bn(sd, f"{base}._block.1", p["BatchNorm_0"], s["BatchNorm_0"])
    _conv(sd, f"{base}._block.3", p["Conv_1"])
    _bn(sd, f"{base}._block.4", p["BatchNorm_1"], s["BatchNorm_1"])
    if "Conv_2" in p:
        _conv(sd, f"{base}.downsample.0", p["Conv_2"])
        _bn(sd, f"{base}.downsample.1", p["BatchNorm_2"], s["BatchNorm_2"])


def tokenizer_state_dict_from_state(
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any],
    codebook,
    cluster_size: Optional[Any] = None,
) -> StateDict:
    """JAX tokenizer (``TokenizerState.params``, ``.batch_stats`` and
    ``.vq.codebook``) -> ``models.tokenizer.VQAutoEncoder`` state_dict.

    ``cluster_size`` (L, K) fills the reference's ``vq.cluster_size``
    buffer, which inference never reads; ones when omitted.
    """
    sd = _autoencoder_state_dict(params, batch_stats)
    codebook = np.asarray(codebook, np.float32)
    if codebook.ndim != 3:
        raise ValueError(f"codebook must be (L, K, D), got {codebook.shape}")
    sd["vq.embedding"] = _t(codebook)
    if cluster_size is None:
        cluster_size = np.ones(codebook.shape[:2], np.float32)
    sd["vq.cluster_size"] = _t(cluster_size)
    return sd


def _autoencoder_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                            ) -> StateDict:
    """The conv encoder and decoder of JAX's ``_AEModule`` (the tokenizer's
    and the SOM autoencoder's) -> ``encoder.*`` and ``decoder.*`` keys."""
    sd: StateDict = {}
    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    _conv(sd, "encoder._conv_1", enc_p["Conv_0"])
    stack_p = enc_p["ResidualStack_0"]
    stack_s = enc_s["ResidualStack_0"]
    i = 0
    while f"Residual_{i}" in stack_p:
        _residual(
            sd, f"encoder._residual_stack._stack.{i}",
            stack_p[f"Residual_{i}"], stack_s[f"Residual_{i}"],
        )
        i += 1

    dec_p, dec_s = params["decoder"], batch_stats["decoder"]
    _conv(sd, "decoder.decoder_stack.0", dec_p["Conv_0"])
    j = 0
    while f"UpscaleResidual_{j}" in dec_p:
        base = f"decoder.decoder_stack.{j + 1}"
        p, s = dec_p[f"UpscaleResidual_{j}"], dec_s[f"UpscaleResidual_{j}"]
        _bn(sd, f"{base}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])
        _conv(sd, f"{base}.conv1", p["Conv_0"])
        _bn(sd, f"{base}.bn2", p["BatchNorm_1"], s["BatchNorm_1"])
        _conv(sd, f"{base}.conv2", p["Conv_1"])
        if "Conv_2" in p:
            _conv(sd, f"{base}.conv_residual", p["Conv_2"])
        j += 1
    _conv(sd, f"decoder.decoder_stack.{j + 1}", dec_p["Conv_1"])
    return sd


def tokenizer_vq_stats(
    codebook,
    activation_count: Optional[Any] = None,
    accumulated_error: Optional[Any] = None,
) -> StateDict:
    """The JAX ``VQState``'s ``activation_count`` and ``accumulated_error``
    (L, K) as the tensors ``VectorQuantizer.load_stats`` takes; zeros (as
    after ``vq_reset_stats``) when omitted."""
    shape = np.shape(codebook)[:2]
    return {
        name: _t(np.zeros(shape, np.float32) if a is None else a)
        for name, a in (("activation_count", activation_count),
                        ("accumulated_error", accumulated_error))
    }


def tokenizer_checkpoint_from_state(
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any],
    codebook,
    config: Mapping[str, Any],
    directory: str,
    cluster_size: Optional[Any] = None,
    activation_count: Optional[Any] = None,
    accumulated_error: Optional[Any] = None,
) -> str:
    """Write a JAX tokenizer (numpy ``params``, ``batch_stats`` and the
    ``VQState`` arrays, as for ``tokenizer_state_dict_from_state`` and
    ``tokenizer_vq_stats``) as a port tokenizer checkpoint at step 0 under
    ``directory``, with ``config`` (the tokenizer trainer's fields:
    ``embedding_dim``, ``num_embeddings``, ``downscale_steps``,
    ``hidden_planes``, ``in_channels``, ...) embedded. Returns the
    checkpoint's path; ``cli.train_vqae --checkpoint`` resumes from it
    with a fresh optimizer."""
    from world_modelz_tpu_torch.train.checkpoint import save_checkpoint

    sd = tokenizer_state_dict_from_state(params, batch_stats, codebook, cluster_size)
    vq = tokenizer_vq_stats(codebook, activation_count, accumulated_error)
    return save_checkpoint(
        directory, 0, {"tokenizer": sd, "vq_stats": vq}, dict(config))


def som_tokenizer_state_from_state(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                                   som: Any):
    """A JAX ``SomTokenizerState`` (``params``, ``batch_stats`` and the
    ``SomState``: its ``embedding``, ``activation_count``, ``width``,
    ``height``) -> ``models.som_autoencoder.SomTokenizerState``, which
    ``SomAutoEncoder.load_tokenizer_state`` loads (the state_dict with
    ``strict=True``)."""
    from world_modelz_tpu_torch.models.som_autoencoder import SomTokenizerState
    from world_modelz_tpu_torch.ops.som import SomState

    state = SomState(
        embedding=_t(som.embedding),
        activation_count=torch.from_numpy(np.array(som.activation_count, np.int32)),
        width=int(som.width), height=int(som.height))
    return SomTokenizerState(_autoencoder_state_dict(params, batch_stats), state)


_FLAX_LISTS = {"Conv": "convs", "GroupNorm": "norms", "Dense": "dense",
               "ResBlock": "res", "AttentionBlock": "attn"}


def unet_state_dict_from_params(params: Mapping[str, Any], prefix: str = "") -> StateDict:
    """JAX ``UNetDiffusionModel`` or ``SimpleDiffusionModel`` params ->
    ``models.unet``'s state_dict. The port keeps each block's layers in
    lists in flax's creation order, so flax's ``{Kind}_{k}`` is the port's
    ``{list}.{k}`` (``Conv`` -> ``convs``, ``GroupNorm`` -> ``norms``,
    ``Dense`` -> ``dense``, ``ResBlock`` -> ``res``, ``AttentionBlock`` ->
    ``attn``); the attention's 1-D convs ``qkv`` and ``proj_out`` (kernel
    (1, in, out)) become linear layers."""
    sd: StateDict = {}
    for name, p in params.items():
        if name in ("qkv", "proj_out"):
            sd[f"{prefix}{name}.weight"] = _t(np.asarray(p["kernel"])[0].T)
            sd[f"{prefix}{name}.bias"] = _t(p["bias"])
            continue
        kind, _, k = name.rpartition("_")
        key = f"{prefix}{_FLAX_LISTS[kind]}.{k}"
        if kind == "Conv":
            _conv(sd, key, p)
        elif kind == "Dense":
            _linear(sd, key, p)
        elif kind == "GroupNorm":
            _layernorm(sd, key, p)
        else:
            sd.update(unet_state_dict_from_params(p, f"{key}."))
    return sd


def gmlp_state_dict_from_params(params: Mapping[str, Any]) -> StateDict:
    """JAX ``GMLP`` params -> ``models.gmlp.GMLP`` state_dict. The port's
    modules carry flax's names, so the map is one to one: a Dense kernel
    (in, out) becomes a Linear weight (out, in), a LayerNorm's scale its
    weight, ``to_embed``'s embedding its weight, and the spatial gating
    unit's ``proj_weight`` (stored as drawn, eps is subtracted at use) and
    ``proj_bias`` keep their values and names."""
    sd: StateDict = {}

    def walk(prefix: str, node: Mapping) -> None:
        if "kernel" in node:
            _linear(sd, prefix, node)
        elif "scale" in node:
            _layernorm(sd, prefix, node)
        elif "embedding" in node:
            sd[f"{prefix}.weight"] = _t(node["embedding"])
        else:
            for name, child in node.items():
                key = f"{prefix}.{name}" if prefix else name
                if isinstance(child, Mapping):
                    walk(key, child)
                else:
                    sd[key] = _t(child)

    walk("", params)
    return sd


def vq_state_from_state(state: Any):
    """A JAX ``VQState`` (its four arrays: ``codebook`` (L, K, D),
    ``cluster_size``, ``activation_count``, ``accumulated_error``) ->
    ``ops.vq.VQState`` of f32 tensors, e.g. the masked-denoise trainer's
    patch quantizer."""
    from world_modelz_tpu_torch.ops.vq import VQState

    return VQState(*(_t(getattr(state, f)) for f in (
        "codebook", "cluster_size", "activation_count", "accumulated_error")))


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, np.shape(v)


def _refill(tree: Mapping[str, Any], fill) -> Dict[str, Any]:
    return {k: _refill(v, fill) if isinstance(v, Mapping) else fill(np.shape(v))
            for k, v in tree.items()}


def param_key_map(convert_fn, params: Mapping[str, Any]) -> Dict[str, tuple]:
    """``convert_fn``'s (e.g. ``video_state_dict_from_params``) mapping on
    the JAX tree ``params``: port key -> (the JAX leaf's "/"-joined path,
    the JAX axis of each port axis). Found by converting the tree twice,
    once with each leaf filled with its number and once with its elements
    numbered (exact in f32 below 2^24 elements a leaf)."""
    leaves = list(_leaves(params))
    ids = iter(range(len(leaves)))
    by_id = convert_fn(_refill(params, lambda shape: np.full(shape, next(ids), np.float32)))
    numbered = convert_fn(_refill(params, lambda shape: np.arange(
        int(np.prod(shape)), dtype=np.float32).reshape(shape)))
    out = {}
    for key, t in by_id.items():
        if not t.is_floating_point() or t.numel() == 0:
            continue
        path, shape = leaves[int(t.reshape(-1)[0])]
        idx = np.unravel_index(numbered[key].numpy().astype(np.int64), shape)
        perm = []
        for d in range(t.dim()):
            if t.shape[d] == 1:
                perm.append(None)
                continue
            step = [0] * t.dim()
            step[d] = 1
            moved = [j for j in range(len(shape)) if idx[j][tuple(step)] != idx[j][(0,) * t.dim()]]
            perm.append(moved[0])
        out[key] = (path, tuple(perm))
    return out
