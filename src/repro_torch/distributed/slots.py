"""Device slots of the multi-device engines: a stream each, the per-slot
fan-out, and the hand-over of a tensor from one slot to another.

A slot is a position in the device list, keyed by its ordinal
(``dynamic_shards.ShardPlacer``'s convention): ``devices=(cuda:0,) * 4``
is four slots on one card and ``(cpu,) * 4`` four on the CPU.  The
``sharded``, ``forest`` and ``ring`` engines run one Python thread per slot
(``DeviceFanout``) and, on CUDA, each slot's work on a stream of its own:
the slots' kernels can run at once on one card, and the events the chunk
store and the round loops record on the current stream order each slot's
own work only.

A tensor one slot made and another reads (the ring's query blocks and
running lists, the gathers to the lead slot) goes through ``hand_over``:
the copy is issued on the source slot's stream, the destination's stream
waits for it, and the allocator is told the destination uses the result.
On one card ``.to`` returns the same tensor, so the engines never write a
handed-over tensor in place.  Copies between two distinct cards take the
same path; they have not run (the machines this was written on have one
card).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.distributed.dynamic_shards import DeviceFanout

__all__ = ["slot_streams", "on_slot", "hand_over", "run_on_slots"]


def slot_streams(devices: Sequence[torch.device]) -> list:
    """One new CUDA stream per CUDA slot, None for a CPU slot."""
    return [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]


def on_slot(stream: Optional["torch.cuda.Stream"]):
    """Context that makes ``stream`` this thread's current stream (nothing
    for a CPU slot)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def hand_over(t: torch.Tensor, src: Optional["torch.cuda.Stream"], device: torch.device,
              dst: Optional["torch.cuda.Stream"]) -> torch.Tensor:
    """``t``, written on stream ``src``, as a tensor on ``device`` that
    stream ``dst`` may read: the copy (none on the same device) runs on
    ``src``, ``dst`` waits for it, and the result is recorded as in use on
    ``dst``, so the allocator does not reuse its memory before ``dst``'s
    reads are done."""
    if src is None or dst is None:
        return t.to(device)
    with torch.cuda.stream(src):
        out = t.to(device, non_blocking=True)
    done = torch.cuda.Event()
    done.record(src)
    dst.wait_event(done)
    out.record_stream(dst)
    return out


def run_on_slots(fanout: DeviceFanout, streams: list,
                 tasks: Dict[int, Callable[[], None]]) -> Dict[int, float]:
    """Run ``tasks[s]`` on slot ``s``'s thread with its stream current, then
    wait for that stream; returns each slot's seconds (host clock, its
    device work included)."""
    seconds: Dict[int, float] = {}

    def on(s: int, fn: Callable[[], None]) -> Callable[[], None]:
        def run():
            t0 = time.perf_counter()
            with on_slot(streams[s]):
                fn()
            if streams[s] is not None:
                streams[s].synchronize()
            seconds[s] = time.perf_counter() - t0
        return run

    fanout.run({s: on(s, fn) for s, fn in tasks.items()})
    return seconds
