"""The quality-validation harnesses (counterparts of ``scripts/quality_validate.py``,
``scripts/distill_validate.py``, ``scripts/quality_validate_mid.py`` and the
parts of ``scripts/mid_common.py`` they use).

Each trains a MaskDiT on synthetic class-conditional data, samples every
acceleration recipe from shared seeds and scores it by a Frechet distance
and a conditional-accuracy readout.  Run each as
``python -m ezaudio_tpu_torch.validation.<module>``: on CUDA unless
``--device cpu``.
"""
