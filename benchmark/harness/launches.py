"""The profiled stretch with the launch of each device operation: the host
time of the runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
``cudaGraphLaunch``, ...) that enqueued it, paired with the operation by
the trace's correlation id. A program span's markers give its host
interval on the profiler's clock; the operations launched inside that
interval are the span's own, wherever and whenever they ran on the
device. The operations a replayed CUDA graph runs share its launch.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from benchmark.harness.trace import PREFIX, Stretch, _sync

Launch = Tuple[float, float, float]  # (host launch, device start, device end), us


def profile(fn) -> Tuple[Stretch, List[Launch]]:
    """Run ``fn()`` under ``torch.profiler`` and reduce its events as
    ``trace.profile`` does; also return, for each device operation whose
    runtime call the trace holds, its ``Launch``, sorted by launch."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        _sync()
    st, runtime, ops = Stretch(), {}, []
    for e in prof.events():
        r = e.time_range
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith(PREFIX):
            if not on_device:
                st.spans.append((e.name[len(PREFIX):], r.start, r.end))
        elif on_device:
            st.device.append((e.name, r.start, r.end))
            ops.append((e.id, r.start, r.end))
        else:
            st.host.append((e.name, r.start, r.end))
            if e.name.startswith("cu"):  # a CUDA runtime or driver call
                runtime[e.id] = r.start
    return st, sorted((runtime[c], s, e) for c, s, e in ops if c in runtime)
