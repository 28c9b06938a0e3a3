"""The quality-validation and product harnesses (counterparts of
``scripts/quality_validate.py``, ``distill_validate.py``,
``quality_validate_mid.py``, ``mid_common.py``, ``distill_serve_mid.py``,
``quality_edit_controlnet_mid.py``, ``verify_checkpoints.py`` and
``calibrate_{pesq,nsim}_mnru.py``).

The first three train a MaskDiT on synthetic class-conditional data,
sample every acceleration recipe from shared seeds and score it by a
Frechet distance and a conditional-accuracy readout; the product harnesses
take a mid-scale EzAudio through its public surfaces (a distilled student
saved, reloaded and served, editing, the energy ControlNet); the last three
check published checkpoints and calibrate the quality metrics.  Run each as
``python -m ezaudio_tpu_torch.validation.<module>``: on CUDA unless
``--device cpu``.
"""
