"""What every kernel wrapper of the port shares: the launch counts, the
CPU-or-one-card rule, argument checks and the CUDA error report."""

from __future__ import annotations

import functools
import threading

import torch

__all__ = ["LAUNCHES", "reset_launches", "sm_count"]

# the device last selected in the library's runtime, per thread (the
# runtime's current device is per thread)
_SELECTED = threading.local()

# kernel launches per wrapper; a wrapper counts where it launches its
# kernel and nowhere else ("lane_*" one launch each for every lane of a
# batch, "rank1_step" steps of four or five, "rank1_cluster", "rank1_grid" and
# "bounded_grid" walks (one launch each), "rank1_cluster_lanes" one launch
# each for every lane of a batch, "blocked_step" pivot slots of six,
# "blocked_cluster" and "blocked_grid" blocks of K slots (one launch each)
# and "blocked_ray" the blocked engine's launch after each flush;
# "*_batch" one launch each for every lane of a batch; "*_stage" the single
# stages launched to check them; "shard_pivot" one launch each for every
# lane of a sharded pivot, "shard_vectors" one each a rank-K sharded pivot)
LAUNCHES = {"fused_flush": 0, "blocked_inner_block": 0, "fused_fma": 0,
            "lane_dual": 0, "lane_primal": 0, "lane_bounded": 0,
            "bounded_grid": 0, "rank1_step": 0, "rank1_stage": 0,
            "rank1_cluster": 0, "rank1_cluster_lanes": 0, "rank1_grid": 0,
            "blocked_step": 0,
            "blocked_ray": 0,
            "blocked_stage": 0, "blocked_cluster": 0, "blocked_grid": 0,
            "blocked_cluster_batch": 0, "fused_flush_batch": 0,
            "blocked_ray_batch": 0, "shard_pivot": 0, "shard_vectors": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU; raises on a mix, or on a
    device that has no kernel here."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA "
                     f"device; got {sorted(str(t.device) for t in tensors)}")


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


def lib_for(device: torch.device):
    """The kernels' library, with ``device`` selected in its own CUDA
    runtime. The library links its runtime statically, so only its own
    calls change that runtime's current device: it is set once per thread
    and device, not at every launch."""
    from .build import load_library

    lib = load_library()
    index = device.index or 0
    if getattr(_SELECTED, "index", None) != index:
        raise_on(lib, lib.tpulp_set_device(index), "set device")
        _SELECTED.index = index
    return lib


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of the CUDA ``device`` (asked once a
    device)."""
    return _sms(device.index or 0)


def stream_of(device: torch.device) -> int:
    """The raw handle of torch's current stream on ``device`` (the lookup
    the Triton launcher uses; ``torch.cuda.current_stream`` builds a Stream
    object every call)."""
    return torch._C._cuda_getCurrentRawStream(device.index or 0)


def raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tpulp_error_string(err).decode()
        raise RuntimeError(f"tpulp_torch {what}: CUDA error {err} ({msg})")


def suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError(f"kernels take float32 or float64, not {dtype}")
