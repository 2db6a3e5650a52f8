"""Profiling helpers.

The reference ships no tracing (SURVEY.md §5 — a commented-out <chrono>
include is all there is). Here every ISP stage is wrapped in a
jax.named_scope (`isp_*`, pipeline.py), so a jax.profiler trace attributes
device time per stage. trace_profile() captures such a trace around a
callable for TensorBoard/Perfetto; device_kernel_events() reads the GPU
kernels back out of it, and hlo_stage_scopes() + stage_device_times()
attribute their time to the stages through the compiled module's op_name
metadata (fused stages go to the scope of the fusion's own metadata).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Callable, Dict, Iterable, List, Tuple

import jax


def trace_profile(fn: Callable, *args, log_dir: str):
    """Run fn(*args) under a jax.profiler trace written to log_dir;
    returns fn's result."""
    with jax.profiler.trace(log_dir):
        out = fn(*args)
        jax.block_until_ready(out)
    return out


_OP_NAME = re.compile(r'op_name="([^"]*)"')
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\(|\{)")
_SCOPE = re.compile(r"(?:^|/)(isp_[a-z_]+)")


def hlo_stage_scopes(hlo_text: str) -> Dict[str, str]:
    """Map each instruction of a compiled module's HLO text to the
    innermost `isp_*` named scope (pipeline.py) of its op_name metadata.
    A fusion without a scope of its own takes the scope most common among
    the instructions of the computation it calls."""
    own: Dict[str, str] = {}
    calls: Dict[str, str] = {}
    members: Dict[str, Counter] = {}
    comp = None
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m is None:
            c = _COMP.match(line)
            if c is not None and line.rstrip().endswith("{"):
                comp = c.group(1)
            continue
        name = m.group(1)
        op = _OP_NAME.search(line)
        scopes = _SCOPE.findall(op.group(1)) if op else []
        if scopes:
            own[name] = scopes[-1]
            if comp is not None:
                members.setdefault(comp, Counter())[scopes[-1]] += 1
        cm = _CALLS.search(line)
        if cm is not None:
            calls[name] = cm.group(1)
    out = dict(own)
    for name, callee in calls.items():
        if name not in out and members.get(callee):
            out[name] = members[callee].most_common(1)[0][0]
    return out


def stage_device_times(events: Iterable[Tuple[str, int]],
                       scopes: Dict[str, str]) -> Dict[str, int]:
    """Sum device event durations (ns) per `isp_*` stage. events: (HLO
    instruction name, duration ns) pairs; names without a stage count
    under "other"."""
    out: Dict[str, int] = {}
    for name, dur in events:
        stage = scopes.get(name, "other")
        out[stage] = out.get(stage, 0) + int(dur)
    return out


def device_kernel_events(xplane_path: str) -> Dict[str, List[Tuple[str, int]]]:
    """(HLO instruction, duration ns) of every event on each GPU device
    line of a jax.profiler trace, keyed by "<plane>/<line>". The
    instruction is the event's `hlo_op` stat when present, else its
    name."""
    from jax.profiler import ProfileData

    out: Dict[str, List[Tuple[str, int]]] = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = []
            for ev in line.events:
                stats = dict(ev.stats)
                evs.append((str(stats.get("hlo_op", ev.name)),
                            int(ev.duration_ns)))
            out[f"{plane.name}/{line.name}"] = evs
    return out
