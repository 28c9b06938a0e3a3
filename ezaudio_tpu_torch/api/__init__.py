from ezaudio_tpu_torch.api.ezaudio import EzAudio

__all__ = ["EzAudio"]
