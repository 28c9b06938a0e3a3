"""Carry weights from the JAX package's parameter trees into the port.

The JAX package keeps channel-last layouts: Linear ``kernel`` (in, out),
Conv1d ``kernel`` (k, in, out), ConvTranspose1d ``kernel`` (k, in, out)
time-flipped into correlation orientation.  The port keeps the reference
torch layouts and names, so these functions are the inverse of the JAX
package's torch -> jax converters:

  * :func:`maskdit_state_dict_from_jax` — ``dit_params["params"]`` ->
    :class:`~ezaudio_tpu_torch.models.maskdit.MaskDiT` state dict;
  * :func:`controlnet_state_dict_from_jax` — ``cn_params["params"]`` ->
    :class:`~ezaudio_tpu_torch.models.controlnet.DiTControlNet` state dict;
  * :func:`vae_state_dict_from_jax` — AudioVAE params (``encoder`` and
    ``decoder`` subtrees) -> :class:`~ezaudio_tpu_torch.codecs.oobleck.AudioVAE`;
  * :func:`t5_state_dict_from_jax` — T5 params ->
    :class:`~ezaudio_tpu_torch.text.t5.T5Encoder`;
  * :func:`clap_params_to_torch` — CLAP params ->
    :class:`~ezaudio_tpu_torch.models.clap.CLAP` (transformers names);
  * :func:`hubert_params_to_torch` — HubertEncoder params ->
    :class:`~ezaudio_tpu_torch.models.hubert.HubertEncoder` (transformers names).

Inputs are nested dicts of numpy arrays (``jax.device_get`` of the
trees); outputs map names to float32 ``torch.Tensor``.  Because the port
uses the reference names, a reference DiT state dict loads directly, and a
reference VAE state dict after :func:`fold_weight_norm`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(dst, prefix, p):
    dst[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        dst[f"{prefix}.bias"] = _t(p["bias"])


def _norm(dst, prefix, p):
    dst[f"{prefix}.weight"] = _t(p["weight"])
    if "bias" in p:
        dst[f"{prefix}.bias"] = _t(p["bias"])


def _conv(dst, prefix, p):
    dst[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        dst[f"{prefix}.bias"] = _t(p["bias"])


def _conv_t(dst, prefix, p):
    # (k, in, out) correlation orientation -> torch (in, out, k)
    dst[f"{prefix}.weight"] = _t(np.asarray(p["kernel"])[::-1].transpose(1, 2, 0))
    dst[f"{prefix}.bias"] = _t(p["bias"])


def _attention(dst, prefix, p):
    for name in ("to_q", "to_k", "to_v", "proj"):
        _lin(dst, f"{prefix}.{name}", p[name])
    for name in ("norm_q", "norm_k"):
        if name in p:
            _norm(dst, f"{prefix}.{name}", p[name])


def _block(dst, prefix, p, cfg):
    _norm(dst, f"{prefix}.norm1", p["norm1"])
    _norm(dst, f"{prefix}.norm3", p["norm3"])
    _attention(dst, f"{prefix}.attn", p["attn"])
    if cfg.get("rope_mode", "none") == "shared":
        head_dim = cfg["embed_dim"] // cfg["num_heads"]
        dst[f"{prefix}.attn.rotary.inv_freq"] = 1.0 / (
            10000.0 ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    _lin(dst, f"{prefix}.mlp.net.0.proj", p["mlp"]["proj_in"])
    _lin(dst, f"{prefix}.mlp.net.2", p["mlp"]["proj_out"])
    if "cross_attn" in p:
        _norm(dst, f"{prefix}.norm2", p["norm2"])
        _attention(dst, f"{prefix}.cross_attn", p["cross_attn"])
    if "norm_context" in p:
        _norm(dst, f"{prefix}.norm_context", p["norm_context"])
    a = p["adaln"]
    _lin(dst, f"{prefix}.adaln.lora_a", a["lora_a"])
    _lin(dst, f"{prefix}.adaln.lora_b", a["lora_b"])
    if "scale_shift_table" in a:
        dst[f"{prefix}.adaln.scale_shift_table"] = _t(a["scale_shift_table"])
    if "skip_fusion" in p:
        sf = p["skip_fusion"]
        _lin(dst, f"{prefix}.skip_linear", sf["skip_linear"])
        if "skip_norm" in sf:
            _norm(dst, f"{prefix}.skip_norm", sf["skip_norm"])


def _embedders(dst, prefix, m, cfg):
    """Patch embed, time and context embedders and ``time_ada``: the
    modules a UDiT and its ControlNet share."""
    p_size, in_ch = cfg.get("patch_size", 1), cfg["in_chans"]
    k = np.asarray(m["patch_embed"]["kernel"]).reshape(p_size, in_ch, -1)
    dst[f"{prefix}patch_embed.proj.weight"] = _t(k.transpose(2, 1, 0))
    dst[f"{prefix}patch_embed.proj.bias"] = _t(m["patch_embed"]["bias"])
    _lin(dst, f"{prefix}time_embed.mlp.0", m["time_embed"]["fc1"])
    _lin(dst, f"{prefix}time_embed.mlp.2", m["time_embed"]["fc2"])
    if "context_embed" in m:  # none in the MAE pretraining stage
        _lin(dst, f"{prefix}context_embed.0", m["context_embed"]["fc1"])
        _lin(dst, f"{prefix}context_embed.2", m["context_embed"]["fc2"])
    _lin(dst, f"{prefix}time_ada", m["time_ada"])


def maskdit_state_dict_from_jax(params: Dict[str, Any], cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX MaskDiT params (``{'mask_embed', 'model': {...}}``) -> port
    MaskDiT state dict.  ``cfg`` is the ``model:`` config block."""
    sd: Dict[str, torch.Tensor] = {}
    if "mask_embed" in params:
        sd["mask_embed"] = _t(params["mask_embed"])
    m = params["model"]
    _embedders(sd, "model.", m, cfg)
    _lin(sd, "model.time_ada_final", m["time_ada_final"])
    half = cfg["depth"] // 2
    for i in range(half):
        _block(sd, f"model.in_blocks.{i}", m[f"in_blocks_{i}"], cfg)
        _block(sd, f"model.out_blocks.{i}", m[f"out_blocks_{i}"], cfg)
    _block(sd, "model.mid_block", m["mid_block"], cfg)
    fb = m["final_block"]
    _norm(sd, "model.final_block.norm", fb["norm"])
    _lin(sd, "model.final_block.linear", fb["linear"])
    if "final_conv" in fb:
        _conv(sd, "model.final_block.final_layer", fb["final_conv"])
    return sd


def controlnet_state_dict_from_jax(params: Dict[str, Any], model_cfg: dict,
                                   controlnet_cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX DiTControlNet params -> port
    :class:`~ezaudio_tpu_torch.models.controlnet.DiTControlNet` state dict.
    ``model_cfg`` is the ``model:`` block, ``controlnet_cfg`` the
    ``controlnet:`` block."""
    sd: Dict[str, torch.Tensor] = {}
    _embedders(sd, "", params, model_cfg)
    for i in range(model_cfg["depth"] // 2):
        _block(sd, f"in_blocks.{i}", params[f"in_blocks_{i}"], model_cfg)
        _lin(sd, f"controlnet_zero_blocks.{i}", params[f"zero_blocks_{i}"])
    pre = params["controlnet_pre"]
    _conv(sd, "controlnet_pre.conv_in", pre["conv_in"])
    _conv(sd, "controlnet_pre.conv_out", pre["conv_out"])
    if controlnet_cfg.get("cond_mask"):
        sd["controlnet_pre.mask_embed"] = _t(pre["mask_embed"])
    for i in range(len(controlnet_cfg["cond_blocks"]) - 1):
        _conv(sd, f"controlnet_pre.blocks.{i}.0", pre[f"pyramid{i}_conv1"])
        _conv(sd, f"controlnet_pre.blocks.{i}.2", pre[f"pyramid{i}_conv2"])
    return sd


def _snake(dst, prefix, p):
    dst[f"{prefix}.alpha"] = _t(p["alpha"])
    dst[f"{prefix}.beta"] = _t(p["beta"])


def _resunit(dst, prefix, p):
    _snake(dst, f"{prefix}.layers.0", p["act1"])
    _conv(dst, f"{prefix}.layers.1", p["conv1"])
    _snake(dst, f"{prefix}.layers.2", p["act2"])
    _conv(dst, f"{prefix}.layers.3", p["conv2"])


def vae_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AudioVAE params -> port AudioVAE state dict (encoder and decoder)."""
    sd: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    n = sum(1 for k in enc if k.startswith("block"))
    _conv(sd, "encoder.layers.0", enc["stem"])
    for i in range(n):
        bp, pre = enc[f"block{i}"], f"encoder.layers.{1 + i}.layers"
        for r in range(3):
            _resunit(sd, f"{pre}.{r}", bp[f"res{r}"])
        _snake(sd, f"{pre}.3", bp["act"])
        _conv(sd, f"{pre}.4", bp["down"])
    _snake(sd, f"encoder.layers.{1 + n}", enc["act"])
    _conv(sd, f"encoder.layers.{2 + n}", enc["head"])
    dec = params["decoder"]
    n = sum(1 for k in dec if k.startswith("block"))
    _conv(sd, "decoder.layers.0", dec["stem"])
    for j in range(n):
        bp, pre = dec[f"block{j}"], f"decoder.layers.{1 + j}.layers"
        _snake(sd, f"{pre}.0", bp["act"])
        _conv_t(sd, f"{pre}.1", bp["up"])
        for r in range(3):
            _resunit(sd, f"{pre}.{2 + r}", bp[f"res{r}"])
    _snake(sd, f"decoder.layers.{1 + n}", dec["act"])
    _conv(sd, f"decoder.layers.{2 + n}", dec["head"])
    return sd


def t5_state_dict_from_jax(params: Dict[str, Any], num_layers: int) -> Dict[str, torch.Tensor]:
    """JAX T5Encoder params -> port T5Encoder state dict."""
    sd: Dict[str, torch.Tensor] = {"embed_tokens.weight": _t(params["embedding"])}
    for i in range(num_layers):
        b, pre = params[f"block_{i}"], f"block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = _t(b["ln_attn"]["weight"])
        for name in ("q", "k", "v", "o"):
            sd[f"{pre}.0.SelfAttention.{name}.weight"] = _t(
                np.asarray(b["attn"][name]["kernel"]).T)
        if "relative_attention_bias" in b["attn"]:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = _t(
                b["attn"]["relative_attention_bias"])
        sd[f"{pre}.1.layer_norm.weight"] = _t(b["ln_ff"]["weight"])
        for name, p in b["ff"].items():
            sd[f"{pre}.1.DenseReluDense.{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd["final_layer_norm.weight"] = _t(params["final_layer_norm"]["weight"])
    return sd


def fold_weight_norm(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Fold torch ``weight_norm`` (dim=0) pairs ``*.weight_g``/``*.weight_v``
    into ``*.weight`` = g * v / ||v|| (norm over every axis but the first;
    for ConvTranspose1d that is per input channel, as torch defines it)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        v = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[: -len("_v")]
            g = torch.as_tensor(np.asarray(sd[base + "_g"]))
            norm = v.float().pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
            out[base] = g.reshape(-1, *([1] * (v.ndim - 1))) / norm.clamp_min(1e-12) * v
        else:
            out[k] = v
    return out


def _ln(dst, prefix, p):
    """A flax LayerNorm or GroupNorm (``scale``, ``bias``)."""
    dst[f"{prefix}.weight"] = _t(p["scale"])
    dst[f"{prefix}.bias"] = _t(p["bias"])


def clap_params_to_torch(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX CLAP params -> port CLAP state dict (the inverse of
    ``ezaudio_tpu/models/clap.py::convert_clap_state_dict``).  ``cfg`` is a
    ``ClapConfig`` of either package."""
    sd: Dict[str, torch.Tensor] = {"logit_scale_a": _t(params["logit_scale_a"]),
                                   "logit_scale_t": _t(params["logit_scale_t"])}
    at, enc = params["audio_tower"], "audio_model.audio_encoder"
    for name, key in (("weight", "bn_scale"), ("bias", "bn_bias"),
                      ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        sd[f"{enc}.batch_norm.{name}"] = _t(at[key])
    # flax Conv (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)
    sd[f"{enc}.patch_embed.proj.weight"] = _t(
        np.asarray(at["patch_proj"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{enc}.patch_embed.proj.bias"] = _t(at["patch_proj"]["bias"])
    if cfg.audio.enable_patch_layer_norm:
        _ln(sd, f"{enc}.patch_embed.norm", at["patch_norm"])
    _ln(sd, f"{enc}.norm", at["norm"])
    for i, depth in enumerate(cfg.audio.depths):
        for j in range(depth):
            b, pre = at[f"stage_{i}_block_{j}"], f"{enc}.layers.{i}.blocks.{j}"
            _ln(sd, f"{pre}.layernorm_before", b["norm_before"])
            _ln(sd, f"{pre}.layernorm_after", b["norm_after"])
            a = b["attention"]
            for name in ("query", "key", "value"):
                _lin(sd, f"{pre}.attention.self.{name}", a[name])
            sd[f"{pre}.attention.self.relative_position_bias_table"] = _t(
                a["relative_position_bias_table"])
            _lin(sd, f"{pre}.attention.output.dense", a["proj"])
            _lin(sd, f"{pre}.intermediate.dense", b["mlp_in"])
            _lin(sd, f"{pre}.output.dense", b["mlp_out"])
        if i < len(cfg.audio.depths) - 1:
            d, pre = at[f"stage_{i}_downsample"], f"{enc}.layers.{i}.downsample"
            _ln(sd, f"{pre}.norm", d["norm"])
            _lin(sd, f"{pre}.reduction", d["reduction"])

    tt, emb = params["text_tower"], "text_model.embeddings"
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{emb}.{name}.weight"] = _t(tt[name]["embedding"])
    _ln(sd, f"{emb}.LayerNorm", tt["embed_norm"])
    _lin(sd, "text_model.pooler.dense", tt["pooler"])
    for i in range(cfg.text.num_hidden_layers):
        pre, p = f"text_model.encoder.layer.{i}", (lambda n, i=i: tt[f"layer_{i}_{n}"])
        for name in ("query", "key", "value"):
            _lin(sd, f"{pre}.attention.self.{name}", p(name))
        _lin(sd, f"{pre}.attention.output.dense", p("attn_out"))
        _ln(sd, f"{pre}.attention.output.LayerNorm", p("attn_norm"))
        _lin(sd, f"{pre}.intermediate.dense", p("mlp_in"))
        _lin(sd, f"{pre}.output.dense", p("mlp_out"))
        _ln(sd, f"{pre}.output.LayerNorm", p("mlp_norm"))
    for side in ("audio", "text"):
        for name in ("linear1", "linear2"):
            _lin(sd, f"{side}_projection.{name}", params[f"{side}_projection"][name])
    return sd


def hubert_params_to_torch(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX HubertEncoder params -> port HubertEncoder state dict (the
    inverse of ``ezaudio_tpu/models/hubert.py::convert_hubert_state_dict``;
    the positional conv's weight is the folded one).  ``cfg`` is a
    ``HubertConfig`` of either package."""
    sd: Dict[str, torch.Tensor] = {}
    fe = params["feature_extractor"]
    for i in range(len(cfg.conv_kernel)):
        pre = f"feature_extractor.conv_layers.{i}"
        _conv(sd, f"{pre}.conv", fe[f"conv_{i}"])
        if cfg.feat_extract_norm == "group" and i == 0:
            _ln(sd, f"{pre}.layer_norm", fe["group_norm"])
        elif cfg.feat_extract_norm == "layer":
            _ln(sd, f"{pre}.layer_norm", fe[f"layer_norm_{i}"])
    _ln(sd, "feature_projection.layer_norm", params["fp_layer_norm"])
    _lin(sd, "feature_projection.projection", params["fp_projection"])
    _conv(sd, "encoder.pos_conv_embed.conv", params["pos_conv_embed"]["conv"])
    _ln(sd, "encoder.layer_norm", params["encoder_layer_norm"])
    for i in range(cfg.num_hidden_layers):
        p, pre = params[f"layer_{i}"], f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{pre}.attention.{name}", p["attention"][name])
        _ln(sd, f"{pre}.layer_norm", p["layer_norm"])
        _ln(sd, f"{pre}.final_layer_norm", p["final_layer_norm"])
        for name in ("intermediate_dense", "output_dense"):
            _lin(sd, f"{pre}.feed_forward.{name}", p["feed_forward"][name])
    return sd
