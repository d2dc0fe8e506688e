"""PyTorch / CUDA port of the ERA-Solver sampling system and its
autoregressive serving path.

A second package beside the JAX reference (``repro``).  Module names
follow the reference so each module's counterpart is easy to find
(``repro_torch.core.era`` ports ``repro.core.era``, and so on).  The port
imports ``torch`` and never ``jax`` or ``repro``; only the parity tests
import both.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise (see :mod:`repro_torch.device`).
The three kernels are hand-written for Hopper:
:mod:`repro_torch.kernels.era_update` (Triton) and
:mod:`repro_torch.kernels.flash_attention` (CUDA C++) on the sampling path,
and :mod:`repro_torch.kernels.decode_attention` (CUDA C++) with
``flash_attention`` on the AR path (:mod:`repro_torch.launch.serve`).
"""
