"""jaxpr-based graph tracer + pattern search.

The reference builds its pruning IR by tracing torch.jit to ONNX and parsing
the result into Node objects (graph/graph.py:107-267), then searches it with
a tiny graph-expression language borrowed from hiddenlayer ("mul > transpose
> matmul", transform/ge.py:9-170, used via Graph.search at graph.py:664-673).

The JAX equivalent traces with ``jax.make_jaxpr`` — the functional IR
XLA actually compiles — into the same Node shape (op, inputs, outputs,
param_names), and searches it with the same ``a > b > c`` chain language.
The declarative node groups in builders.py remain the source of truth for
pruning decisions (SURVEY.md §7 item 4); this tracer provides

- program capture for inspection/debugging (the reference's L3 role),
- ``search`` for op-chain patterns (GEParser parity),
- :func:`validate_node_groups`: cross-checks the declared groups against
  the traced program — every declared param path must be a real traced
  input, and any prunable-looking kernel not covered by a group is
  reported (the reference's unprunable bookkeeping / dedup guards,
  base_hybrid_sparse_optimizer.py:139-178).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax


@dataclasses.dataclass
class TraceNode:
    """One primitive application — the analogue of graph/node.py's Node."""

    id: str
    op: str                       # jax primitive name (dot_general, conv, ...)
    inputs: Tuple[str, ...]       # producing node ids or param/input names
    param_names: Tuple[str, ...]  # params pytree paths consumed directly
    shape: Optional[Tuple[int, ...]] = None
    # positional operands: producer node id / param path / "<arg>" for
    # unlabeled function inputs / None for literals+consts. Lets analyses
    # distinguish a conv's data operand from its weight operand even when
    # the weight is a computed value (traced quantizer output — the
    # situation graph.py:525-662 collapses in the reference).
    arg_ids: Tuple[Optional[str], ...] = ()
    # selected scalar/tuple eqn params (e.g. a conv's feature_group_count
    # — the sound depthwise discriminator; kernel shape alone can't tell a
    # depthwise conv from a regular conv on 1-channel input)
    attrs: Optional[Dict[str, Any]] = None

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"TraceNode({self.id}: {self.op} <- {list(self.inputs)})"


class TracedGraph:
    """Dataflow DAG of primitive ops from one ``jax.make_jaxpr`` trace."""

    def __init__(self, nodes: List[TraceNode],
                 output_ids: Optional[Sequence[str]] = None):
        self.nodes = nodes
        self.by_id = {n.id: n for n in nodes}
        # producers of the traced function's actual outputs (graph.py:243-250
        # dummy-output analogue); None for graphs built before tracing
        self.output_ids: Tuple[str, ...] = tuple(output_ids or ())

    # -- construction -----------------------------------------------------

    @staticmethod
    def trace(fn, *example_args, params=None) -> "TracedGraph":
        """Trace ``fn(*example_args)``; if ``params`` (a pytree) is the
        first argument, traced graph inputs are labeled with its '/'-joined
        paths (the reference labels nodes with module param names,
        graph.py:878-912)."""
        closed = jax.make_jaxpr(fn)(*example_args)

        # var -> label for params-pytree leaves
        var_labels: Dict[Any, str] = {}
        if params is not None:
            flat, _ = jax.tree_util.tree_flatten_with_path(params)
            paths = ["/".join(str(getattr(k, "key", k)) for k in kp)
                     for kp, _ in flat]
            n_param_leaves = len(flat)
            for var, path in zip(closed.jaxpr.invars[:n_param_leaves], paths):
                var_labels[var] = path

        nodes: List[TraceNode] = []
        producer: Dict[Any, str] = {}

        def walk(jaxpr, prefix: str):
            for i, eqn in enumerate(jaxpr.eqns):
                nid = f"{prefix}{i}"
                op = eqn.primitive.name
                inputs: List[str] = []
                pnames: List[str] = []
                arg_ids: List[Optional[str]] = []
                for v in eqn.invars:
                    if hasattr(v, "val"):  # literal
                        arg_ids.append(None)
                        continue
                    if v in var_labels:
                        pnames.append(var_labels[v])
                        inputs.append(var_labels[v])
                        arg_ids.append(var_labels[v])
                    elif v in producer:
                        inputs.append(producer[v])
                        arg_ids.append(producer[v])
                    else:
                        arg_ids.append("<arg>")
                outshape = (tuple(eqn.outvars[0].aval.shape)
                            if eqn.outvars else None)
                attrs = None
                if op == "conv_general_dilated":
                    attrs = {
                        k: eqn.params[k]
                        for k in ("feature_group_count", "batch_group_count",
                                  "window_strides")
                        if k in eqn.params
                    }
                nodes.append(TraceNode(nid, op, tuple(inputs),
                                       tuple(pnames), outshape,
                                       tuple(arg_ids), attrs))
                for v in eqn.outvars:
                    producer[v] = nid
                # recurse into pjit/closed-call subjaxprs so the whole
                # program is visible (torch inlines via _jit_pass_inline,
                # graph/utils.py:41-174)
                for sub in eqn.params.values():
                    if hasattr(sub, "jaxpr"):
                        inner = sub.jaxpr if hasattr(sub.jaxpr, "eqns") else sub
                        # map inner invars to outer labels
                        for iv, ov in zip(inner.invars, eqn.invars):
                            if hasattr(ov, "val"):  # literal
                                continue
                            if ov in var_labels:
                                var_labels[iv] = var_labels[ov]
                            elif ov in producer:
                                producer[iv] = producer[ov]
                        walk(inner, f"{nid}/")
                        # inner outvars feed the eqn outvars
                        for iv, ov in zip(inner.outvars, eqn.outvars):
                            if iv in producer:
                                producer[ov] = producer[iv]
        walk(closed.jaxpr, "")
        outputs = [producer[v] for v in closed.jaxpr.outvars
                   if v in producer]
        return TracedGraph(nodes, output_ids=outputs)

    # -- queries -----------------------------------------------------------

    def ops(self) -> List[str]:
        return [n.op for n in self.nodes]

    def incoming(self, node: TraceNode) -> List[TraceNode]:
        return [self.by_id[i] for i in node.inputs if i in self.by_id]

    def search(self, pattern: str) -> List[List[TraceNode]]:
        """Find op chains matching ``"a > b > c"`` (GEParser's sequence
        form, ge.py:9-170): consecutive ops connected by direct dataflow.
        ``*`` matches any single op. Returns each match as [node_a, ...]."""
        want = [p.strip() for p in pattern.split(">")]
        if not want:
            return []
        matches: List[List[TraceNode]] = []

        def extend(chain: List[TraceNode], k: int):
            if k == len(want):
                matches.append(list(chain))
                return
            last = chain[-1]
            for n in self.nodes:
                if last.id in n.inputs and _op_match(n.op, want[k]):
                    chain.append(n)
                    extend(chain, k + 1)
                    chain.pop()

        for n in self.nodes:
            if _op_match(n.op, want[0]):
                extend([n], 1)
        return matches

    def params_used(self) -> List[str]:
        out: List[str] = []
        seen = set()
        for n in self.nodes:
            for p in n.param_names:
                if p not in seen:
                    seen.add(p)
                    out.append(p)
        return out


def _op_match(op: str, pat: str) -> bool:
    return pat == "*" or op == pat or op.startswith(pat)


def validate_node_groups(graph: TracedGraph, groups: Sequence[Any],
                         params) -> Dict[str, List[str]]:
    """Cross-check declared node groups against a traced program.

    Returns {"missing": [declared paths never consumed by the trace],
             "uncovered": [traced kernel paths not in any group]} — both
    empty means the declaration is consistent with the actual model.
    """
    traced = set(graph.params_used())
    declared = set()
    for g in groups:
        for e in g.entries:
            declared.add(e.path)
    missing = sorted(p for p in declared if p not in traced)
    uncovered = sorted(
        p for p in traced
        if p.endswith(("kernel", "embedding")) and p not in declared
    )
    return {"missing": missing, "uncovered": uncovered}
