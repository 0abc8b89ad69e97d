"""Compiled-HLO collective audit — the N-independence regression guard.

Multi-device scaling of the sharded tree hinges on one property: the
shard-local planner programs (parallel/local_plan.py) never move collective
bytes proportional to the tree size N — only O(K) candidate exchanges,
O(K*depth_loc) witness psums, and one root gather.  The GSPMD-default
programs are known to all-gather the full [16, N] state through their sort
(fatal at config-5 scale: the collective inventory measured it), which is
exactly the
regression this audit exists to catch: a planner edit that quietly falls
back to the GSPMD sort.

Partitioning decisions are made by GSPMD at compile time, independent of
the target backend, so the audit compiles on an N-virtual-device CPU mesh
and inspects the optimized HLO text.  The PASS/FAIL check is *two-size
N-independence*: each program is compiled again at depth+2 (4x the state);
total collective bytes may grow only by the deeper witness output (extra
levels x 2K-column psum rows), never with N.  A fixed >=state-size
threshold cannot be the gate — at toy audit shapes the legitimate
O(K*depth_loc) witness psums exceed one [16, N] state array — so the
per-collective oversize list is reported as advisory data only; the
growth check is what catches a planner regression (an O(N) all-gather
quadruples between the two sizes).

Used by tools/collective_inventory.py (reporting) and
tests/test_parallel.py::test_collective_n_independence (slow tier, failing
test — reverting the local planner to the GSPMD sort turns the suite red).

Reference framing: the reference has no distributed machinery at all
(SURVEY §2.3 — single-threaded Rust, src/indexed_merkle_tree.rs); this bar
is held to the same regression discipline as bit-exactness.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field

_SHAPE = re.compile(r"(f32|u32|s32|u8|pred|s8|bf16|u64|s64|f64)\[([0-9,]*)\]")

_BYTES = {"f32": 4, "u32": 4, "s32": 4, "u8": 1, "s8": 1, "pred": 1,
          "bf16": 2, "u64": 8, "s64": 8, "f64": 8}

_COLL_LINE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+(all-gather|all-reduce|all-to-all|"
    r"collective-permute|reduce-scatter|all-gather-start|all-reduce-start)\(")


def shape_bytes(s: str) -> int:
    """Total bytes of every typed shape in an HLO result string."""
    total = 0
    for dt, dims in _SHAPE.findall(s):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _BYTES[dt]
    return total


def inventory(hlo: str):
    """[(kind, out_shape, bytes)] for every collective in the HLO text."""
    out = []
    for line in hlo.splitlines():
        m = _COLL_LINE.search(line)
        if m:
            out.append((m.group(2), m.group(1), shape_bytes(m.group(1))))
    return out


@dataclass
class ProgramAudit:
    name: str
    rows: list                  # [(kind, shape, bytes)] at the base depth
    total_bytes: int            # sum at base depth
    total_bytes_big: int        # sum at depth+2 (4x state)
    allowed_big: int            # growth allowance (deeper witness output)
    state_bytes: int            # one [16, N] leaf array at base depth

    @property
    def oversize(self):
        """Advisory: collectives >= one [16, N] state array at the audit
        shape.  NOT part of ok — O(K*depth_loc) witness psums legitimately
        exceed the toy-size state (see module docstring)."""
        return [r for r in self.rows if r[2] >= self.state_bytes]

    @property
    def n_independent(self) -> bool:
        return self.total_bytes_big <= self.allowed_big

    @property
    def ok(self) -> bool:
        return self.n_independent


@dataclass
class AuditResult:
    devices: int
    depth: int
    k: int
    programs: list = dc_field(default_factory=list)

    @property
    def failures(self):
        return [p for p in self.programs if not p.ok]

    def summary(self) -> str:
        lines = []
        for p in self.programs:
            status = "OK" if p.ok else (
                ">=STATE-SIZE COLLECTIVE" if p.oversize else "GROWS WITH N")
            lines.append(
                f"{p.name}: {p.total_bytes:,} B at depth {self.depth} -> "
                f"{p.total_bytes_big:,} B at depth {self.depth + 2} "
                f"(allowed {p.allowed_big:,}) [{status}]")
        return "\n".join(lines)


def _compiled_collective_rows(fn, args):
    import jax
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return inventory(hlo)


def _tree_state(depth: int, mesh, devices: int):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from imt_tpu.tree import indexed

    shard = NamedSharding(mesh, P(None, "shard"))
    repl = NamedSharding(mesh, P())
    tree = indexed.IndexedMerkleTree(depth)
    return tree, (
        jax.device_put(tree.vals, shard),
        jax.device_put(tree.next_vals, shard),
        jax.device_put(tree.next_idxs, shard),
        tuple(jax.device_put(l, shard if l.shape[1] >= devices else repl)
              for l in tree.levels),
    )


def audit_local_plan(devices: int = 8, depth: int = 12, k: int = 256,
                     chain: int = 4) -> AuditResult:
    """Compile the four shard-local programs at `depth` and `depth+2`;
    return per-program collective volumes + pass/fail.  Requires a process
    with >= `devices` JAX devices (CPU virtual devices are fine)."""
    import random

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from imt_tpu.ops import field
    from imt_tpu.parallel import local_plan, sharded

    d = devices
    depth2 = depth + 2
    mesh = sharded.make_mesh(d)
    repl = NamedSharding(mesh, P())

    tree, state = _tree_state(depth, mesh, d)
    _, state2 = _tree_state(depth2, mesh, d)

    rng = random.Random(7)
    new_vals = jax.device_put(jnp.asarray(field.ints_to_limbs(
        [rng.randrange(1, field.P) for _ in range(k)])), repl)
    nv1 = new_vals[None]
    nvb = jnp.broadcast_to(new_vals, (chain, *new_vals.shape))

    key = (tuple(dev.id for dev in mesh.devices.flat),)
    local_plan._MESHES[key] = mesh
    nr = tree.node_repr

    def build(depth_):
        return (
            local_plan._local_insert_batch_fn(depth_, k, d, key, nr),
            local_plan._local_insert_batch_fn(depth_, k, d, key, nr, chain),
            local_plan._local_non_inclusion_fn(depth_, k, d, key, depth_, nr),
            local_plan._local_insert_batch_witness_fn(depth_, k, d, key,
                                                      depth_, nr),
        )

    p1 = build(depth)
    p2 = build(depth2)

    def args_for(st, prog_idx):
        base = (*st[:3], *st[3])
        return [
            (*base, nv1, jnp.int32(0)),
            (*base, nvb, jnp.int32(0)),
            (*base, new_vals),
            (*base, new_vals, jnp.int32(0)),
        ][prog_idx]

    names = [
        "insert_batch (shard-local planner)",
        f"insert_batches chain b={chain} (shard-local)",
        "non_inclusion_witness (shard-local)",
        "insert_batch witness (shard-local)",
    ]
    state_bytes = (1 << depth) * 16 * 4
    res = AuditResult(devices=d, depth=depth, k=k)
    for i, name in enumerate(names):
        rows = _compiled_collective_rows(p1[i].run, args_for(state, i))
        t1 = sum(nb for _, _, nb in rows)
        rows2 = _compiled_collective_rows(p2[i].run, args_for(state2, i))
        t2 = sum(nb for _, _, nb in rows2)
        # witness outputs legitimately deepen with the tree: allow the +2
        # extra levels' 2K-column psum rows (48 RNS channels x f32) plus
        # 4*k slack for helper-bit rows — NOTHING proportional to the 4x
        # state
        allowed = t1 + 2 * (2 * k) * 48 * 4 + 4 * k
        res.programs.append(ProgramAudit(
            name=name, rows=rows, total_bytes=t1, total_bytes_big=t2,
            allowed_big=allowed, state_bytes=state_bytes))
    return res
