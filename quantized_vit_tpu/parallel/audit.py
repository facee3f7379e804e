"""Collectives audit.

The reference has no distributed code at all (SURVEY.md §2.4).
:func:`collective_stats` parses the post-SPMD-partitioner HLO of a jitted
function and returns every collective op with its shape and byte count —
the exact communication GSPMD or a shard_map inserted for the chosen
shardings. Works on the virtual CPU mesh (the partitioner emits the same
collectives for the same mesh shape regardless of backend), so multi-device
communication volume is auditable without the devices. Byte counts are
full-tensor sizes S: a ring all-reduce of S bytes over p devices moves
2*S*(p-1)/p bytes through each device; all-gather/reduce-scatter move
S*(p-1)/p.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

import jax
import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")

_OP_RE = re.compile(
    r"=\s*(?:\(?([a-z]+\d*)\[([\d,]*)\])?[^=]*?"
    r"\b(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all)"
    r"(?:-start)?\(")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: Tuple[int, ...]
    bytes: int          # full-tensor size S
    group_size: int = 0  # replica group size (0 = unknown)


def collective_stats(fn, *args, static_argnames=None,
                     donate_argnums=None) -> List[CollectiveOp]:
    """All collectives in the COMPILED (post-partitioning) HLO of fn(*args).

    fn should already carry its shardings (NamedSharding'd inputs or
    in_shardings); run under `with mesh:` if it relies on the ambient mesh.
    """
    jitted = fn if isinstance(fn, jax.stages.Wrapped) else jax.jit(
        fn, static_argnames=static_argnames)
    txt = jitted.lower(*args).compile().as_text()
    return parse_collectives(txt)


_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _replica_group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(line)  # iota form [n_groups, group_size]<=[N]
    if m:
        return int(m.group(2))
    return 0


def parse_collectives(hlo_text: str) -> List[CollectiveOp]:
    out: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        if "-done(" in line:
            continue  # async pair: count the -start only
        if dtype is None:
            # tuple-shaped op: fall back to the first dtype[shape] in line
            m2 = re.search(r"([a-z]+\d*)\[([\d,]*)\]", line)
            if not m2:
                continue
            dtype, dims = m2.group(1), m2.group(2)
        shape = tuple(int(d) for d in dims.split(",") if d) if dims else ()
        nbytes = int(np.prod(shape, dtype=np.int64)) * _DTYPE_BYTES.get(
            dtype, 4) if shape else _DTYPE_BYTES.get(dtype, 4)
        group = _replica_group_size(line)
        if kind == "reduce-scatter":
            # the HLO result is ONE SHARD; report the full reduced
            # tensor S = shard * group
            nbytes *= max(group, 1)
        out.append(CollectiveOp(kind, dtype, shape, nbytes, group))
    return out


def summarize(ops: Sequence[CollectiveOp]) -> Dict[str, Dict[str, float]]:
    summary: Dict[str, Dict[str, float]] = {}
    for op in ops:
        s = summary.setdefault(op.kind, {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += op.bytes
    return summary
