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
  * :func:`udit_state_dict_from_jax` — a bare UDiT's params, every
    architecture switch (PEs, time and context fusion, cls, 2-D input);
  * :func:`cfg_wrapper_state_dict_from_jax` — ``models/cfg_wrappers.py``;
  * :func:`vae_state_dict_from_jax` — AudioVAE params (``encoder`` and
    ``decoder`` subtrees; folded kernels or live weight norm, kept) ->
    :class:`~ezaudio_tpu_torch.codecs.oobleck.AudioVAE`;
  * :func:`dac_state_dict_from_jax`, :func:`encodec_state_dict_from_jax`,
    :func:`discriminator_state_dict_from_jax` — the codecs and the GAN
    discriminator (``codecs/{dac,encodec,discriminator}.py``);
  * :func:`t5_state_dict_from_jax` — T5 params ->
    :class:`~ezaudio_tpu_torch.text.t5.T5Encoder`;
  * :func:`clap_params_to_torch` — CLAP params ->
    :class:`~ezaudio_tpu_torch.models.clap.CLAP` (transformers names);
  * :func:`hubert_params_to_torch` — HubertEncoder params ->
    :class:`~ezaudio_tpu_torch.models.hubert.HubertEncoder` (transformers names);
  * :func:`whisper_state_dict_from_jax` — ``WhisperModel`` params ->
    :class:`~ezaudio_tpu_torch.models.whisper.WhisperForConditionalGeneration`
    (transformers names).

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


def _weight(dst, prefix, p, to_torch):
    """A conv's ``kernel``, or its live weight norm ``v``/``g`` (kept, with
    ``g`` shaped (C, 1, ...) as torch's ``weight_g``)."""
    if "v" in p:
        v = to_torch(np.asarray(p["v"]))
        dst[f"{prefix}.weight_v"] = _t(v)
        dst[f"{prefix}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, *[1] * (v.ndim - 1)))
    else:
        dst[f"{prefix}.weight"] = _t(to_torch(np.asarray(p["kernel"])))
    if "bias" in p:
        dst[f"{prefix}.bias"] = _t(p["bias"])


def _conv(dst, prefix, p):
    # (k, in, out) -> torch (out, in, k)
    _weight(dst, prefix, p, lambda k: k.transpose(2, 1, 0))


def _conv_t(dst, prefix, p):
    # (k, in, out) correlation orientation -> torch (in, out, k)
    _weight(dst, prefix, p, lambda k: k[::-1].transpose(1, 2, 0))


def _conv2d(dst, prefix, p):
    # (kh, kw, in, out) -> torch (out, in, kh, kw)
    _weight(dst, prefix, p, lambda k: k.transpose(3, 2, 0, 1))


def _attention(dst, prefix, p):
    for name in ("to_q", "to_k", "to_v", "proj"):
        _lin(dst, f"{prefix}.{name}", p[name])
    for name in ("norm_q", "norm_k"):
        if name in p:
            _norm(dst, f"{prefix}.{name}", p[name])


def _inv_freq(head_dim: int) -> torch.Tensor:
    return 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))


ROTARY_BUFFERS = {"none": (), "shared": ("rotary",), "x_only": ("rotary",),
                  "dual": ("rotary_x", "rotary_c")}


def _block(dst, prefix, p, cfg):
    _norm(dst, f"{prefix}.norm1", p["norm1"])
    _norm(dst, f"{prefix}.norm3", p["norm3"])
    _attention(dst, f"{prefix}.attn", p["attn"])
    for name in ROTARY_BUFFERS[cfg.get("rope_mode", "none")]:
        dst[f"{prefix}.attn.{name}.inv_freq"] = _inv_freq(cfg["embed_dim"] // cfg["num_heads"])
    mlp = p["mlp"]
    _lin(dst, f"{prefix}.mlp.net.0.proj", mlp["proj_in"])
    _lin(dst, f"{prefix}.mlp.net.2", mlp["proj_out"])
    for name in ("alpha", "beta"):  # the snake activations'
        if name in mlp:
            dst[f"{prefix}.mlp.net.0.{name}"] = _t(mlp[name])
    if "cross_attn" in p:
        _norm(dst, f"{prefix}.norm2", p["norm2"])
        _attention(dst, f"{prefix}.cross_attn", p["cross_attn"])
    if "norm_context" in p:
        _norm(dst, f"{prefix}.norm_context", p["norm_context"])
    a = p.get("adaln", {})  # none under time_fusion='token'
    for name in ("time_ada", "lora_a", "lora_b"):
        if name in a:
            _lin(dst, f"{prefix}.adaln.{name}", a[name])
    if "scale_shift_table" in a:
        dst[f"{prefix}.adaln.scale_shift_table"] = _t(a["scale_shift_table"])
    if "skip_fusion" in p:
        sf = p["skip_fusion"]
        _lin(dst, f"{prefix}.skip_linear", sf["skip_linear"])
        if "skip_norm" in sf:
            _norm(dst, f"{prefix}.skip_norm", sf["skip_norm"])


def _pe(dst, prefix, p, method, dim, length):
    """A ``PEWrapper``: ``abs_pe``, the conv PE's weight norm, or the
    sinusoidal table (a buffer the JAX package computes, made here)."""
    from ezaudio_tpu_torch.ops.embeddings import sinusoidal_table

    if method == "abs":
        dst[f"{prefix}.abs_pe"] = _t(p["abs_pe"])
    elif method == "conv":
        _conv(dst, f"{prefix}.conv_pe.conv", p["conv_pe"]["conv"])
    elif method == "sinu":
        dst[f"{prefix}.sinu_pe.pe"] = sinusoidal_table(length, dim)


def _embedders(dst, prefix, m, cfg):
    """Patch embed, positional embeddings, time and context embedders and
    ``time_ada``: the modules a UDiT and its ControlNet share."""
    p_size, in_ch, dim = cfg.get("patch_size", 1), cfg["in_chans"], cfg["embed_dim"]
    if cfg.get("input_type", "1d") == "2d":
        k = np.asarray(m["patch_embed"]["kernel"]).reshape(p_size, p_size, in_ch, -1)
        dst[f"{prefix}patch_embed.proj.weight"] = _t(k.transpose(3, 2, 0, 1))
        H, W = cfg["img_size"]
        num_patches = (H // p_size) * (W // p_size)
    else:
        k = np.asarray(m["patch_embed"]["kernel"]).reshape(p_size, in_ch, -1)
        dst[f"{prefix}patch_embed.proj.weight"] = _t(k.transpose(2, 1, 0))
        num_patches = cfg["img_size"] // p_size
    dst[f"{prefix}patch_embed.proj.bias"] = _t(m["patch_embed"]["bias"])
    _pe(dst, f"{prefix}x_pe", m.get("x_pe"), cfg.get("pe_method", "none"), dim, num_patches)
    _lin(dst, f"{prefix}time_embed.mlp.0", m["time_embed"]["fc1"])
    _lin(dst, f"{prefix}time_embed.mlp.2", m["time_embed"]["fc2"])
    if "context_embed" in m:  # none in the MAE pretraining stage
        _lin(dst, f"{prefix}context_embed.0", m["context_embed"]["fc1"])
        _lin(dst, f"{prefix}context_embed.2", m["context_embed"]["fc2"])
        _pe(dst, f"{prefix}context_pe", m.get("context_pe"),
            cfg.get("context_pe_method", "none"), dim, cfg.get("context_max_length"))
    if "time_ada" in m:  # none under time_fusion 'token' and 'ada'
        _lin(dst, f"{prefix}time_ada", m["time_ada"])


def maskdit_state_dict_from_jax(params: Dict[str, Any], cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX MaskDiT params (``{'mask_embed', 'model': {...}}``) -> port
    MaskDiT state dict.  ``cfg`` is the ``model:`` config block."""
    sd: Dict[str, torch.Tensor] = {}
    if "mask_embed" in params:
        sd["mask_embed"] = _t(params["mask_embed"])
    sd.update({f"model.{k}": v for k, v in udit_state_dict_from_jax(params["model"],
                                                                    cfg).items()})
    return sd


def udit_state_dict_from_jax(m: Dict[str, Any], cfg: dict) -> Dict[str, torch.Tensor]:
    """JAX UDiT params -> port :class:`~ezaudio_tpu_torch.models.udit.UDiT`
    state dict; ``cfg`` holds the UDiT's keyword arguments (a ``model:``
    block)."""
    sd: Dict[str, torch.Tensor] = {}
    _embedders(sd, "", m, cfg)
    if "time_ada_final" in m:
        _lin(sd, "time_ada_final", m["time_ada_final"])
    if "cls_embed" in m:
        _lin(sd, "cls_embed.0", m["cls_embed"]["fc1"])
        _lin(sd, "cls_embed.2", m["cls_embed"]["fc2"])
    if "time_pe" in m:
        sd["time_pe.abs_pe"] = _t(m["time_pe"]["abs_pe"])
    half = cfg["depth"] // 2
    for i in range(half):
        _block(sd, f"in_blocks.{i}", m[f"in_blocks_{i}"], cfg)
        _block(sd, f"out_blocks.{i}", m[f"out_blocks_{i}"], cfg)
    _block(sd, "mid_block", m["mid_block"], cfg)
    fb = m["final_block"]
    _norm(sd, "final_block.norm", fb["norm"])
    _lin(sd, "final_block.linear", fb["linear"])
    if "final_conv" in fb:
        conv = _conv2d if cfg.get("input_type", "1d") == "2d" else _conv
        conv(sd, "final_block.final_layer", fb["final_conv"])
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


def cfg_wrapper_state_dict_from_jax(params: Dict[str, Any],
                                    backbone_sd: Dict[str, torch.Tensor] = None
                                    ) -> Dict[str, torch.Tensor]:
    """JAX ``EmbeddingCFG`` / ``CFGModel`` / ``ConcatModel`` params -> the
    port's ``models/cfg_wrappers.py`` state dict; ``backbone_sd``, the
    backbone's own (for example :func:`udit_state_dict_from_jax`), goes
    under ``backbone.``."""
    sd: Dict[str, torch.Tensor] = {}
    if "cfg_embedding" in params:  # a bare EmbeddingCFG
        sd["cfg_embedding"] = _t(params["cfg_embedding"])
    if "context_cfg" in params:
        sd["context_cfg.cfg_embedding"] = _t(params["context_cfg"]["cfg_embedding"])
    i = 0
    while f"down{i}" in params:
        _conv(sd, f"down.{i}", params[f"down{i}"])
        i += 1
    for k, v in (backbone_sd or {}).items():
        sd[f"backbone.{k}"] = v
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


def _dac_snake(dst, prefix, p):
    dst[f"{prefix}.alpha"] = _t(np.asarray(p["alpha"]).reshape(1, -1, 1))


def _dac_resunit(dst, prefix, p):
    _dac_snake(dst, f"{prefix}.block.0", p["act1"])
    _conv(dst, f"{prefix}.block.1", p["conv1"])
    _dac_snake(dst, f"{prefix}.block.2", p["act2"])
    _conv(dst, f"{prefix}.block.3", p["conv2"])


def rvq_state_dict_from_jax(params: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``ResidualVectorQuantize`` (``q{i}`` subtrees) -> the port's,
    under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for q, qp in params.items():
        pre = f"{prefix}quantizers.{int(q[1:])}"
        _conv(sd, f"{pre}.in_proj", qp["in_proj"])
        _conv(sd, f"{pre}.out_proj", qp["out_proj"])
        sd[f"{pre}.codebook.weight"] = _t(qp["codebook"])
    return sd


def dac_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DAC params -> port DAC state dict (descript's names)."""
    sd: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    n = sum(1 for k in enc if k.startswith("block"))
    _conv(sd, "encoder.block.0", enc["stem"])
    for i in range(n):
        bp, pre = enc[f"block{i}"], f"encoder.block.{1 + i}.block"
        for r in range(3):
            _dac_resunit(sd, f"{pre}.{r}", bp[f"res{r}"])
        _dac_snake(sd, f"{pre}.3", bp["act"])
        _conv(sd, f"{pre}.4", bp["down"])
    _dac_snake(sd, f"encoder.block.{1 + n}", enc["act"])
    _conv(sd, f"encoder.block.{2 + n}", enc["head"])
    sd.update(rvq_state_dict_from_jax(params["quantizer"], "quantizer."))
    dec = params["decoder"]
    n = sum(1 for k in dec if k.startswith("block"))
    _conv(sd, "decoder.model.0", dec["stem"])
    for i in range(n):
        bp, pre = dec[f"block{i}"], f"decoder.model.{1 + i}.block"
        _dac_snake(sd, f"{pre}.0", bp["act"])
        _conv_t(sd, f"{pre}.1", bp["up"])
        for r in range(3):
            _dac_resunit(sd, f"{pre}.{2 + r}", bp[f"res{r}"])
    _dac_snake(sd, f"decoder.model.{1 + n}", dec["act"])
    _conv(sd, f"decoder.model.{2 + n}", dec["head"])
    return sd


def _lstm(dst, prefix, p):
    """flax ``OptimizedLSTMCell`` layers ``lstm{i}`` -> ``torch.nn.LSTM``:
    the input kernels ``ii/if/ig/io`` (no bias) stacked in torch's gate
    order i, f, g, o into ``weight_ih_l{i}``, the hidden ones ``h*`` into
    ``weight_hh_l{i}`` with their biases in ``bias_hh_l{i}``; ``bias_ih``
    is 0."""
    for i in range(sum(1 for k in p if k.startswith("lstm"))):
        c = p[f"lstm{i}"]
        wi = np.concatenate([np.asarray(c[f"i{g}"]["kernel"]).T for g in "ifgo"])
        dst[f"{prefix}.weight_ih_l{i}"] = _t(wi)
        dst[f"{prefix}.weight_hh_l{i}"] = _t(np.concatenate(
            [np.asarray(c[f"h{g}"]["kernel"]).T for g in "ifgo"]))
        dst[f"{prefix}.bias_ih_l{i}"] = torch.zeros(wi.shape[0])
        dst[f"{prefix}.bias_hh_l{i}"] = _t(np.concatenate(
            [np.asarray(c[f"h{g}"]["bias"]) for g in "ifgo"]))


def _seanet_res(dst, prefix, p):
    _conv(dst, f"{prefix}.block.1", p["conv1"])
    _conv(dst, f"{prefix}.block.3", p["conv2"])


def encodec_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Encodec params -> port Encodec state dict (its ``model``
    Sequentials' indices: ELUs and the transposed convs' trims take
    slots)."""
    sd: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    n_res = sum(1 for k in enc if k.startswith("res0_"))
    _conv(sd, "encoder.model.0", enc["stem"])
    idx = 1
    for i in range(sum(1 for k in enc if k.startswith("down"))):
        for j in range(n_res):
            _seanet_res(sd, f"encoder.model.{idx}", enc[f"res{i}_{j}"])
            idx += 1
        _conv(sd, f"encoder.model.{idx + 1}", enc[f"down{i}"])  # after its ELU
        idx += 2
    if "lstm" in enc:
        _lstm(sd, f"encoder.model.{idx}.lstm", enc["lstm"])
        idx += 1
    _conv(sd, f"encoder.model.{idx + 1}", enc["head"])
    dec = params["decoder"]
    _conv(sd, "decoder.model.0", dec["stem"])
    idx = 1
    if "lstm" in dec:
        _lstm(sd, "decoder.model.1.lstm", dec["lstm"])
        idx = 2
    for i in range(sum(1 for k in dec if k.startswith("up"))):
        _conv_t(sd, f"decoder.model.{idx + 1}.convtr", dec[f"up{i}"])  # after its ELU
        idx += 2
        for j in range(n_res):
            _seanet_res(sd, f"decoder.model.{idx}", dec[f"res{i}_{j}"])
            idx += 1
    _conv(sd, f"decoder.model.{idx + 1}", dec["head"])
    for q, qp in params["quantizer"].items():
        sd[f"quantizer.layers.{int(q[2:])}.codebook"] = _t(qp["codebook"])
    return sd


def discriminator_state_dict_from_jax(params: Dict[str, Any], periods, rates,
                                      fft_sizes) -> Dict[str, torch.Tensor]:
    """JAX Discriminator params -> port Discriminator state dict, the
    sub-discriminators in its order: MPDs, MSDs, MRDs."""
    sd: Dict[str, torch.Tensor] = {}
    subs = ([f"mpd_{p}" for p in periods] + [f"msd_{r}" for r in rates]
            + [f"mrd_{f}" for f in fft_sizes])
    for k, name in enumerate(subs):
        p, pre = params[name], f"discriminators.{k}"
        conv = _conv2d if name.startswith(("mpd", "mrd")) else _conv
        if name.startswith("mrd"):
            for key in p:
                if key.startswith("band"):
                    b, li = key[4:].split("_conv")
                    conv(sd, f"{pre}.band_convs.{b}.{li}.0", p[key])
        else:
            for i in range(sum(1 for key in p if key[4:].isdigit())):
                conv(sd, f"{pre}.convs.{i}.0", p[f"conv{i}"])
        conv(sd, f"{pre}.conv_post", p["conv_post"])
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


def _whisper_attn(dst, prefix, p):
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(dst, f"{prefix}.{name}", p[name])


def whisper_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX ``WhisperModel`` params (``{"encoder": ..., "decoder": ...}``) ->
    the port's ``WhisperForConditionalGeneration`` state dict, the inverse of
    ``ezaudio_tpu/models/whisper.py::convert_whisper_state_dict``: dense
    kernels (in, out) -> (out, in), conv kernels (k, in, out) -> (out, in, k),
    LayerNorm ``scale`` -> ``weight``; ``proj_out.weight`` is the tied
    ``embed_tokens``.  ``cfg`` is a ``WhisperConfig`` of either package."""
    sd: Dict[str, torch.Tensor] = {}
    enc, dec = params["encoder"], params["decoder"]
    _conv(sd, "model.encoder.conv1", enc["conv1"])
    _conv(sd, "model.encoder.conv2", enc["conv2"])
    sd["model.encoder.embed_positions.weight"] = _t(enc["embed_positions"])
    for i in range(cfg.encoder_layers):
        p, pre = enc[f"layers_{i}"], f"model.encoder.layers.{i}"
        _whisper_attn(sd, f"{pre}.self_attn", p["self_attn"])
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            _ln(sd, f"{pre}.{name}", p[name])
        _lin(sd, f"{pre}.fc1", p["fc1"])
        _lin(sd, f"{pre}.fc2", p["fc2"])
    _ln(sd, "model.encoder.layer_norm", enc["layer_norm"])
    sd["model.decoder.embed_tokens.weight"] = _t(dec["embed_tokens"])
    sd["model.decoder.embed_positions.weight"] = _t(dec["embed_positions"])
    for i in range(cfg.decoder_layers):
        p, pre = dec[f"layers_{i}"], f"model.decoder.layers.{i}"
        _whisper_attn(sd, f"{pre}.self_attn", p["self_attn"])
        _whisper_attn(sd, f"{pre}.encoder_attn", p["encoder_attn"])
        for name in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            _ln(sd, f"{pre}.{name}", p[name])
        _lin(sd, f"{pre}.fc1", p["fc1"])
        _lin(sd, f"{pre}.fc2", p["fc2"])
    _ln(sd, "model.decoder.layer_norm", dec["layer_norm"])
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd
