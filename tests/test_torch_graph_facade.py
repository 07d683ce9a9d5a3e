"""The port's extraction as one device program, on the CPU.

On a CUDA device ``SIFT`` replays a CUDA graph of ``extract_gray_batch``
(the counterpart of the JAX facade's ``jax.jit``); a graph holds no host
read, so the pipeline must make none. Held here:

  * ``extract_gray_batch`` reads no device value back to the host outside
    the kernels' plain versions (the CPU stand-ins of the CUDA kernels);
  * the cross-octave tail, whose walk runs its fixed iterations over the
    whole mover block, against the JAX package's
    ``detect_all_octaves_batch`` (its ``lax.while_loop``, and its second
    mover tier under ``lax.cond`` in ``vmap``) on the butterfly, where the
    JAX tail walks that tier, and on ``proc_a.pgm``, where it skips it;
  * ``SIFT(..., device="cpu")`` stays eager and equals
    ``extract_gray_batch`` bit for bit.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu_torch import FAST_CONFIG, SIFT, SiftConfig, extract_gray
from siftmetal_tpu_torch.ops.kernels import KERNEL_GROUPS, LAUNCHES, device_launches, group_launches
from siftmetal_tpu_torch.ops.kernels.detect import detect_candidates_plain
from siftmetal_tpu_torch.sift import detect as PD
from siftmetal_tpu_torch.sift.batched import build_pyramid_batch, extract_gray_batch
from siftmetal_tpu_torch.utils.io import load_image
from torch_bits import assert_same_bits

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
LUMA = np.array([0.212639005871510, 0.715168678767756, 0.072192315360734], np.float32)
PORT = str(pathlib.Path(PD.__file__).resolve().parents[1])

# The ops that read a device value back to the host (bool(), int(),
# .item(), nonzero's data-dependent size).
HOST_READS = (
    torch.ops.aten._local_scalar_dense,
    torch.ops.aten.is_nonzero,
    torch.ops.aten.item,
    torch.ops.aten.nonzero,
)


class HostReads(TorchDispatchMode):
    """Records every host read and the port's frames it was made from;
    reads made inside a kernel's plain version (a function ``*_plain``)
    are only counted."""

    def __init__(self):
        super().__init__()
        self.outside = []
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            frames, f = [], sys._getframe(1)
            while f is not None:
                if f.f_code.co_filename.startswith(PORT):
                    frames.append((f.f_code.co_name, f"{f.f_code.co_filename}:{f.f_lineno}"))
                f = f.f_back
            if any(name.endswith("_plain") for name, _ in frames):
                self.inside += 1
            else:
                self.outside.append((str(func), frames[:2]))
        return func(*args, **(kwargs or {}))


def _noise(b=2, h=120, w=160, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32))


@pytest.mark.parametrize("cfg", [SiftConfig(), FAST_CONFIG], ids=["parity", "fast"])
def test_extraction_reads_nothing_back(cfg):
    """Zero host reads over extract_gray_batch outside the plain kernel
    versions: nothing a CUDA graph could not hold. The mode sees a read
    (the control) and the plain versions' own (their lane chunks)."""
    with HostReads() as control:
        bool((torch.arange(3) > 1).any())
    assert len(control.outside) == 1

    x = _noise()
    with HostReads() as reads:
        _, _, ctr = extract_gray_batch(x, cfg, cfg.num_octaves(120, 160))
    assert reads.outside == []
    assert reads.inside > 0
    assert int(ctr["n_movers"].sum()) > 0          # the mover walk ran


def _jax_detect_fed_plain(dogs, jcfg, monkeypatch):
    """The JAX package's detect_all_octaves_batch through its kernel
    branch (the vmapped cross-octave tail), compiled as one program, its
    Pallas detection kernel replaced by a host callback into the port's
    plain version, which tests/test_torch_detect.py holds to the Pallas
    kernel in interpret mode: both tails read the same slot grids (rows
    H - 2, no tile padding), so their slot lists line up lane for lane."""
    import jax

    from siftmetal_tpu.ops.pallas import detect as pd
    from siftmetal_tpu.sift import detect as JD

    def plain_kernel(dog, soft_threshold, edge_threshold, tile_h=None, emit_fields=True):
        def host(d):
            c = detect_candidates_plain(torch.from_numpy(np.array(d)), soft_threshold,
                                        edge_threshold, emit_fields=emit_fields)
            return (c.cand_col.numpy(), c.slot_ok.numpy(), tuple(t.numpy() for t in c.cand_fields),
                    c.cand_edge.numpy(), c.n_raw.numpy(), c.n_soft.numpy(),
                    c.n_row_dropped.numpy())

        b, s, h, w = dog.shape
        grid = lambda dt: jax.ShapeDtypeStruct((b, s - 2, h - 2, 6), dt)
        frame = jax.ShapeDtypeStruct((b,), jnp.int32)
        shapes = (grid(jnp.int32), grid(jnp.bool_), (grid(jnp.float32),) * 4,
                  grid(jnp.bool_), frame, frame, frame)
        return jax.pure_callback(host, shapes, dog)

    monkeypatch.setattr(pd, "detect_candidates_pallas", plain_kernel)
    monkeypatch.setattr(JD, "_use_pallas_detect", lambda config: True)
    run = jax.jit(lambda ds: JD.detect_all_octaves_batch(ds, jcfg))
    return run([jnp.asarray(d.numpy()) for d in dogs])


@pytest.mark.parametrize("image, tier_b", [("butterfly", True), ("proc_a.pgm", False)])
def test_device_tail_matches_jax_detect(image, tier_b, butterfly, monkeypatch):
    """The tail's one walk of fixed iterations over the mover block against
    the JAX package's tail (lax.while_loop; its tier B under lax.cond in
    vmap, walked on the butterfly and skipped on proc_a.pgm)
    on the port's DoGs: every counter equal; per octave, every slot's
    flags and discrete position equal, and the accepted keypoints' x, y,
    sigma within 1e-4 (the port-vs-JAX keypoint bound of
    tests/test_torch_extract.py; XLA's Taylor step differs by ~3e-5
    relative)."""
    if image == "butterfly":
        gray = butterfly[..., :3] @ LUMA
    else:
        gray = load_image(str(FIXTURES / image))
    gray = torch.from_numpy(np.ascontiguousarray(gray, np.float32))[None]
    cfg = SiftConfig()
    _, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(*gray.shape[-2:]))
    per, ctr = PD.detect_all_octaves_batch(dogs, cfg)
    k1 = PD.mover_budget(cfg, tuple(dogs[0].shape[-2:]))
    assert (int(ctr["n_movers"][0]) > k1) == tier_b

    jper, jctr = _jax_detect_fed_plain(dogs, JConfig(), monkeypatch)
    assert set(jctr) <= set(ctr)
    for key in jctr:
        np.testing.assert_array_equal(ctr[key].numpy(), np.asarray(jctr[key]), err_msg=key)
    n_acc = 0
    for o, (kp, jkp) in enumerate(zip(per, jper)):
        cand = kp.cand_valid.numpy()
        np.testing.assert_array_equal(cand, np.asarray(jkp.cand_valid), err_msg=str(o))
        for name in ("converged", "pass_hard", "pass_edge", "pass_border"):
            np.testing.assert_array_equal(getattr(kp, name).numpy(), np.asarray(getattr(jkp, name)),
                                          err_msg=f"{o} {name}")
        for name in ("scale", "i", "j"):
            np.testing.assert_array_equal(getattr(kp, name).numpy()[cand],
                                          np.asarray(getattr(jkp, name))[cand], err_msg=f"{o} {name}")
        acc = kp.valid.numpy()
        for name in ("x", "y", "sigma"):
            np.testing.assert_allclose(getattr(kp, name).numpy()[acc],
                                       np.asarray(getattr(jkp, name))[acc], atol=1e-4, rtol=0,
                                       err_msg=f"{o} {name}")
        n_acc += int(acc.sum())
    assert n_acc == int(ctr["n_border"][0]) > 1000


def test_cpu_facade_stays_eager():
    """SIFT on the CPU runs extract_gray_batch itself, no graph: the same
    bits as the direct call, batched and for one frame."""
    cfg = SiftConfig()
    x = _noise()
    sift = SIFT(120, 160, cfg, device="cpu")
    n_oct = cfg.num_octaves(120, 160)
    assert_same_bits(sift.extract_batch(x), extract_gray_batch(x, cfg, n_oct))
    assert_same_bits(sift.extract(x[1]), extract_gray(x[1], cfg, n_oct))
    assert sift._graphs == {}


def test_kernel_groups_count_each_wrapper_once():
    """Every launch counter lies in exactly one kernel group, and each of
    the port's device kernels, named as a profiler names it, counts under
    its own group only (resident_orientation_kernel not as
    orientation_kernel, PyTorch's kernels under none)."""
    members = [w for group in KERNEL_GROUPS.values() for w in group]
    assert sorted(members) == sorted(LAUNCHES)
    anon = "(anonymous namespace)::"
    names = {
        f"void {anon}band_tiles_kernel<float, float, false>({anon}Band)": "seed_octave",
        f"void {anon}band_tiles_kernel<__nv_bfloat16, __nv_bfloat16, true>({anon}Band)":
            "seed_octave_bf16",
        f"void {anon}blur_cascade_kernel<float, false>({anon}Band, int)": "blur_cascade",
        f"void {anon}blur_cascade_kernel<__nv_bfloat16, true>({anon}Band, int)": "blur_cascade_bf16",
        f"void {anon}stream_kernel<{anon}Default>({anon}Launch)": "octave_cascade",
        f"void {anon}detect_kernel<true, 5, 8>({anon}Launch)": "detect_candidates",
        f"void {anon}detect_kernel<false, 5, 16>({anon}Launch)": "detect_candidates_lean",
        f"{anon}orientation_kernel({anon}OriLaunch)": "orientation_hist",
        f"void {anon}descriptor_kernel<{anon}Hist48>(float const*)": "descriptor_hist",
        f"void {anon}orient_desc_kernel<{anon}HistAny>(float const*)": "orient_desc",
        f"{anon}resident_orientation_kernel(float const*, float const*)": "orientation_hist_banded",
        f"void {anon}resident_descriptor_kernel<{anon}Hist48>(float const*)":
            "descriptor_hist_banded",
    }
    for name, wrapper in names.items():
        got = {group: n for group, n in device_launches([name]).items() if n}
        assert list(got) == [next(g for g in KERNEL_GROUPS.values() if wrapper in g)], name
    others = ["void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)",
              f"void {anon}layout_scan_kernel(int const*, int, int*)"]
    assert sum(device_launches(others).values()) == 0
    counts = dict.fromkeys(LAUNCHES, 0)
    counts.update(seed_octave=1, octave_oneshot=2, detect_candidates=1)
    by_group = group_launches(counts)
    assert by_group[("seed_octave", "octave_oneshot", "blur_stack")] == 3
    assert by_group[("detect_candidates",)] == 1 and sum(by_group.values()) == 4
