"""Global configuration for desilike_tpu_torch: dtype policy and devices.

Per-evaluation compute runs in float32 on the device the likelihood was
given, the CUDA card when it was given none; host-side initialization
(fiducial tables, fit matrices, window, covariance, whitening, static
design matrices) runs in float64 on the CPU.

Float32 matmuls stay full float32: reduced-precision matmuls inject noise
into the log-posterior that collapses the step-size adaptation of gradient
samplers (the finding recorded at ``desilike_tpu/config.py:17-25``; TF32 is
the Hopper counterpart of the TPU's single-pass bf16).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

HOST_DTYPE = torch.float64
"""Host-side (initialization) precision."""

_DTYPE = torch.float32


def set_dtype(dtype):
    """Set the per-evaluation compute dtype ('float32' or 'float64')."""
    global _DTYPE
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError('compute dtype must be float32 or float64, got {}'.format(dtype))
    _DTYPE = dtype


def get_dtype():
    """Return the per-evaluation compute dtype."""
    return _DTYPE


def device(name='cpu'):
    """Resolve ``name`` to a ``torch.device``; raise if it is not available.

    There is no fallback: asking for 'cuda' on a machine without a usable
    CUDA device is an error, never a silent switch to the CPU.
    """
    dev = torch.device(name)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('device {!r} requested but torch.cuda.is_available() is False'.format(str(dev)))
        if dev.index is None:
            # tensors report an indexed device; compare like with like
            dev = torch.device('cuda', torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError('device {!r} requested but only {:d} CUDA device(s) are visible'.format(
                str(dev), torch.cuda.device_count()))
    elif dev.type != 'cpu':
        raise ValueError('unsupported device {!r}: use "cpu" or "cuda[:i]"'.format(str(dev)))
    return dev
