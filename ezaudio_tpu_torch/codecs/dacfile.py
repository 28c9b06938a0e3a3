"""The ``.dac`` file, windowed compress and decompress, and the CLI
(counterpart of ``ezaudio_tpu/codecs/dacfile.py``; reference
``src/modules/dac/model/base.py`` ``DACFile`` and
``CodecMixin.compress/decompress``, ``dac/utils/{encode,decode}.py``):

  * ``DACFile``: uint16 codes and metadata in one ``np.save``d dict, the
    same bytes as the JAX package's, so a file written by either loads in
    the other;
  * ``compress``: the input's loudness measured and normalized to -16 dB,
    cut into ``win_duration`` windows (the last zero-padded), each
    RVQ-encoded;
  * ``decompress``: each window decoded, stitched, trimmed, and gained
    back to the recorded input loudness (the reconstruction's own loudness
    measured, reference base.py:285).

    python -m ezaudio_tpu_torch.codecs.dacfile encode clip.wav [--ckpt dac.pth]
    python -m ezaudio_tpu_torch.codecs.dacfile decode clip.dac [--device cpu]

The CLI builds ``DAC(sample_rate=...)`` (the 44.1 kHz model's widths) on
the card unless ``--device`` says otherwise, with seeded weights or a
reference ``.pt``/``.pth`` (``convert/checkpoints.py::load_dac``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path

import numpy as np
import torch

from ezaudio_tpu_torch.audio.loudness import integrated_loudness

SUPPORTED_VERSIONS = ["1.0.0"]


@dataclasses.dataclass
class DACFile:
    codes: np.ndarray  # (B, N, T) int
    chunk_length: int
    original_length: int
    input_db: float
    channels: int
    sample_rate: int
    padding: bool
    dac_version: str = SUPPORTED_VERSIONS[-1]

    def save(self, path: str) -> str:
        artifacts = {
            "codes": np.asarray(self.codes).astype(np.uint16),
            "metadata": {
                "input_db": np.float32(self.input_db),
                "original_length": self.original_length,
                "sample_rate": self.sample_rate,
                "chunk_length": self.chunk_length,
                "channels": self.channels,
                "padding": self.padding,
                "dac_version": self.dac_version,
            },
        }
        path = str(Path(path).with_suffix(".dac"))
        with open(path, "wb") as f:
            np.save(f, artifacts)  # the metadata dict is pickled, as the reference's
        return path

    @classmethod
    def load(cls, path: str) -> "DACFile":
        artifacts = np.load(path, allow_pickle=True)[()]
        meta = dict(artifacts["metadata"])
        if meta.get("dac_version") not in SUPPORTED_VERSIONS:
            raise RuntimeError(f"{path}: unsupported dac_version")
        return cls(codes=artifacts["codes"].astype(np.int64),
                   input_db=float(meta["input_db"]),
                   original_length=int(meta["original_length"]),
                   sample_rate=int(meta["sample_rate"]),
                   chunk_length=int(meta["chunk_length"]),
                   channels=int(meta["channels"]),
                   padding=bool(meta["padding"]))


class DACCodec:
    """Loudness-normalized ``.dac`` round trips with a ``DAC`` model, on
    the device its weights are on; waveforms and codes stay numpy."""

    def __init__(self, model):
        self.model = model.eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def compress(self, wav: np.ndarray, sample_rate: int, win_duration: float = 5.0,
                 normalize_db: float = -16.0) -> DACFile:
        """wav (T,) float32 mono -> DACFile (padded-mode windows)."""
        model = self.model
        if sample_rate != model.sample_rate:
            raise ValueError(f"expected {model.sample_rate} Hz input, got {sample_rate}")
        original_length = len(wav)
        input_db = integrated_loudness(wav, sample_rate)
        if normalize_db is not None and np.isfinite(input_db):
            wav = wav * (10 ** ((normalize_db - input_db) / 20))
        hop = model.hop_length
        chunk = int(round(win_duration * sample_rate / hop) * hop)
        n_chunks = max(1, math.ceil(len(wav) / chunk))
        padded = np.zeros(n_chunks * chunk, np.float32)
        padded[: len(wav)] = wav
        x = torch.from_numpy(padded).to(self.device)
        # every window queued before any is read back
        codes = [model.encode(x[i * chunk: (i + 1) * chunk][None, :, None])[1]
                 for i in range(n_chunks)]
        return DACFile(
            codes=torch.cat(codes, -1).cpu().numpy(), chunk_length=chunk // hop,
            original_length=original_length,
            input_db=float(input_db) if np.isfinite(input_db) else -70.0,
            channels=1, sample_rate=sample_rate, padding=True)

    @torch.no_grad()
    def decompress(self, obj: DACFile, normalize_db: float = -16.0) -> np.ndarray:
        model = self.model
        if obj.sample_rate != model.sample_rate:
            raise ValueError(f".dac file was encoded at {obj.sample_rate} Hz but this "
                             f"model runs at {model.sample_rate} Hz")
        codes = torch.from_numpy(obj.codes).to(self.device)
        cl = obj.chunk_length
        outs = [model.decode(model.quantizer.from_codes(codes[..., i: i + cl])[0])
                for i in range(0, codes.shape[-1], cl)]
        wav = torch.cat([o[0, :, 0] for o in outs]).float().cpu().numpy()
        wav = wav[: obj.original_length]
        if normalize_db is not None and obj.input_db > -70.0:
            # gain the reconstruction's own loudness to the recorded input's
            out_db = integrated_loudness(wav, obj.sample_rate)
            if np.isfinite(out_db):
                wav = wav * (10 ** ((obj.input_db - out_db) / 20))
        return wav


# ---------------------------------------------------------------------------
# CLI: python -m ezaudio_tpu_torch.codecs.dacfile encode/decode
# ---------------------------------------------------------------------------

def main(argv=None) -> str:
    import argparse

    from ezaudio_tpu_torch.codecs.dac import DAC
    from ezaudio_tpu_torch.convert.checkpoints import load_dac
    from ezaudio_tpu_torch.data.audio_io import load_wav, save_wav
    from ezaudio_tpu_torch.training.codec_trainer import init_codec_
    from ezaudio_tpu_torch.utils import resolve_device

    ap = argparse.ArgumentParser(description="DAC encode/decode CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)
    enc = sub.add_parser("encode")
    enc.add_argument("input")
    enc.add_argument("--output", default=None)
    enc.add_argument("--win-duration", type=float, default=5.0)
    dec = sub.add_parser("decode")
    dec.add_argument("input")
    dec.add_argument("--output", default=None)
    for p in (enc, dec):
        p.add_argument("--ckpt", default=None, help="a reference DAC .pt/.pth")
        p.add_argument("--sample-rate", type=int, default=44100)
        p.add_argument("--device", default=None, help="default: cuda")
        p.add_argument("--seed", type=int, default=0, help="weights without --ckpt")
    args = ap.parse_args(argv)

    if args.cmd == "decode":
        # the file's rate decides the model's geometry
        args.sample_rate = DACFile.load(args.input).sample_rate
    device = resolve_device(args.device)
    with torch.device(device):
        model = DAC(sample_rate=args.sample_rate)
    if args.ckpt:
        load_dac(model, args.ckpt)
    else:
        init_codec_(model, torch.Generator(device=device).manual_seed(args.seed))
    codec = DACCodec(model)

    if args.cmd == "encode":
        wav = load_wav(args.input, sr=args.sample_rate)
        f = codec.compress(wav, args.sample_rate, win_duration=args.win_duration)
        out = f.save(args.output or os.path.splitext(args.input)[0] + ".dac")
    else:
        f = DACFile.load(args.input)
        out = args.output or os.path.splitext(args.input)[0] + ".wav"
        save_wav(out, codec.decompress(f), f.sample_rate)
    print(out)
    return out


if __name__ == "__main__":
    main()
