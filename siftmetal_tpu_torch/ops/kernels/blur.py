"""Single-sigma Gaussian blur of a stack through the band kernel.

Replaces ``siftmetal_tpu/ops/pallas/blur.py`` ``_blur_kernel`` (through
``blur_pallas`` :61 and ``blur_stack_pallas`` :110): a separable
Gaussian with the half-sample-symmetric boundary, fp32 taps and fp32
accumulation. In the JAX package only
tests call it and the TPU runs the small-octave cascade in XLA
(``siftmetal_tpu/sift/pyramid.py`` ``cascade_slices`` :78); in the port
:func:`blur_stack` blurs the unfused seed through the tiled
``csrc/pyramid.cu`` kernel with one slice and no DoG, and
:func:`blur_cascade` runs a whole small-octave cascade (octaves under 176
rows) in one cooperative launch of the same tile body, stage by stage.

A bf16 stack (the fast preset's blur chain; the bf16 branch of
``siftmetal_tpu/ops/gaussian.py`` ``blur`` :166 with
``out_dtype=float32``) is read as bf16; the X pass rounds its fp32 sum
once to bf16, the Y pass reads that and returns its fp32 sum un-rounded.

Bound on an H100: bytes for the large inputs. The small octaves of the
cascade (<= 120x160 at 640x480) were bound by the host's five launches a
octave; one launch each is what moves them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import cuda as _cuda
from . import LAUNCHES, require, use_kernel
from .pyramid import bands_plain, launch_table, separable_bands


def blur_stack(stack: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur every [H, W] slice of a [..., H, W] fp32 or bf16 stack by
    ``sigma``; the result is fp32."""
    lead = stack.shape[:-2]
    h, w = stack.shape[-2:]
    flat = stack.reshape((-1, h, w))
    if use_kernel(flat, "blur_stack"):
        flat = flat.contiguous()
    gauss, _ = separable_bands(
        flat, (float(sigma),), None, False, "blur_stack", mid_dtype=stack.dtype
    )
    return gauss[:, 0].reshape(lead + (h, w))


def blur_cascade_plain(
    first: torch.Tensor, sigmas: Sequence[float], bf16_chain: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-stage route in PyTorch: slice s + 1 is slice s (rounded to
    bf16 in the bf16 chain) blurred by ``sigmas[s]`` through the plain band
    passes, then the stack and the DoG of consecutive slices."""
    mid = torch.bfloat16 if bf16_chain else torch.float32
    slices = [first.float()]
    chain = first.to(mid)
    for rho in sigmas:
        out = bands_plain(chain, (float(rho),), None, False, mid)[0][:, 0]
        chain = out.to(mid)
        slices.append(out)
    stack = torch.stack(slices, dim=1)
    return stack, stack[:, 1:] - stack[:, :-1]


def blur_cascade(
    first: torch.Tensor, sigmas: Sequence[float], bf16_chain: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The incremental cascade of one octave from its first slice
    [B, H, W] -> fp32 (gaussians [B, n + 1, H, W], dogs [B, n, H, W]),
    n = len(sigmas): what ``sift/pyramid.py`` ``cascade_slices`` with five
    ``blur_stack`` calls, a stack and a subtraction give, bit for bit, in
    one cooperative launch on a CUDA tensor (counted under
    ``blur_cascade``, or ``blur_cascade_bf16`` for the bf16 chain). In the
    bf16 chain ``first`` is bf16 or fp32 (read rounded to bf16; slice 0 and
    the first DoG keep it unrounded); otherwise fp32."""
    name = "blur_cascade_bf16" if bf16_chain else "blur_cascade"
    if not use_kernel(first, name):
        return blur_cascade_plain(first, sigmas, bf16_chain)
    if first.dtype != torch.float32 and not (bf16_chain and first.dtype == torch.bfloat16):
        raise TypeError(f"{name}: no {first.dtype} first slice for this chain")
    require(first, name, first.dtype)
    if first.ndim != 3 or not sigmas:
        raise ValueError(f"{name}: expected [B, H, W] and stages, got {tuple(first.shape)}")
    b, h, w = first.shape
    sig = tuple(float(r) for r in sigmas)
    table = launch_table(sig, first.device)
    n = len(sig)
    gauss = torch.empty((b, n + 1, h, w), dtype=torch.float32, device=first.device)
    dog = torch.empty((b, n, h, w), dtype=torch.float32, device=first.device)
    with _cuda.launch_on(first) as stream:
        _cuda.check(
            _cuda.library("pyramid").blur_cascade(
                table, first.data_ptr(), int(first.dtype == torch.bfloat16),
                int(bf16_chain), b, h, w, n, gauss.data_ptr(), dog.data_ptr(), stream,
            ),
            name,
        )
    LAUNCHES[name] += 1
    return gauss, dog
