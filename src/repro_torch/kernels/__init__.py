"""Attention kernels of the port: hand-written CUDA under ``csrc/`` with a
plain PyTorch version of each, behind the registry of
:mod:`repro_torch.kernels.dispatch`.  The entry points are in
:mod:`repro_torch.kernels.ops`."""
