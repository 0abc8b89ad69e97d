"""Randomized differential soak of the indexed-tree engine vs the oracle.

Drives random workloads — mixed-size insert batches (with adversarial
duplicates, adjacent values, 0 and P-1), sequential witness inserts,
non-inclusion queries, checkpoint round-trips — through both the JAX engine
(dense + sparse-prefix) and the pure-python OracleIndexedTree, asserting
root/acceptance/witness agreement after every step.

Usage: python tools/soak_indexed.py [--rounds 30] [--seed 0]
(CPU-safe; forces the cpu platform like tests/conftest.py.)
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

# imt_tpu is an installed package (pip install -e . — pyproject.toml)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from imt_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()

    import numpy as np

    from imt_tpu.ops import field
    from imt_tpu.tree.indexed import IndexedMerkleTree, insert_leaf
    from imt_tpu.tree.reference_oracle import OracleIndexedTree
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree
    from imt_tpu.utils import checkpoint

    from imt_tpu.tree.reference_oracle import Leaf

    def _oracle_from_engine(dense, OracleCls):
        """Re-seed an oracle to the engine's exact leaf state + slot cursor
        (used after engine-rejected inserts, which consume a slot the
        skip-based oracle replay would not)."""
        o = OracleCls(dense.tree_depth)
        for i in range(dense.num_slots):
            v, nv, ni = dense.get_leaf_ints(i)
            o.preimages[i] = Leaf(v, nv, ni)
        o.count = dense.count
        o._rebuild()
        return o

    rng = random.Random(args.seed)
    t0 = time.time()

    for rnd in range(args.rounds):
        depth = rng.choice([4, 5, 6, 8])
        dense = IndexedMerkleTree(depth)
        sparse = SparseIndexedMerkleTree(depth, initial_capacity_log2=2)
        oracle = OracleIndexedTree(depth)
        inserted: list[int] = []
        budget = (1 << depth) - 2

        def rand_val() -> int:
            mode = rng.random()
            if mode < 0.15 and inserted:          # exact duplicate
                return rng.choice(inserted)
            if mode < 0.3 and inserted:           # adjacent — canonical
                # mod p: (p-1)+1 wraps to 0, the rejected sentinel (the
                # engine canonicalizes every input mod p at the limb
                # boundary, so the differential expectations must too)
                return max(1, rng.choice(inserted) + rng.choice([-1, 1])) \
                    % field.P
            if mode < 0.35:
                return rng.choice([1, 2, field.P - 1, field.P - 2])
            return rng.randrange(1, field.P)

        steps = rng.randrange(2, 5)
        for _ in range(steps):
            # Duplicates: the engine REJECTS duplicate/zero inserts
            # (documented divergence, tree/indexed.py module docstring); the
            # oracle replicates the reference planner, which silently
            # corrupts its linked list on duplicates (src/indexed_merkle_tree
            # .rs:647).  Expected acceptance is computed here; after any
            # rejection the engine has consumed a slot the oracle did not,
            # so the oracle is re-seeded from the engine state.
            kind = rng.random()
            if kind < 0.55 and budget >= 4:       # batched insert
                k = rng.choice([2, 3, 4, 7])
                k = min(k, budget)
                vals = [rand_val() for _ in range(k)]
                expect, seen = [], set(inserted)
                for v in vals:
                    a = v != 0 and v not in seen
                    expect.append(a)
                    if a:
                        seen.add(v)
                okd = dense.insert_batch(vals)
                oks = sparse.insert_batch(list(vals))
                assert okd.tolist() == oks.tolist() == expect, (
                    rnd, vals, okd.tolist(), oks.tolist(), expect)
                budget -= k
                if all(expect):
                    for v in vals:
                        assert oracle.insert(v)["ok"]
                    inserted += vals
                else:
                    # rejected slots desync the slot cursor vs the oracle;
                    # re-seed the oracle to the engine's exact leaf state
                    oracle = _oracle_from_engine(dense, OracleIndexedTree)
                    inserted = [v for v, a in zip(vals, expect) if a] + \
                        inserted
            elif kind < 0.8 and budget >= 1:      # witnessed sequential
                v = rand_val()
                dup = v == 0 or v in inserted
                wd = dense.insert(v)
                ws = sparse.insert(v)
                assert bool(wd.ok.all()) == bool(ws.ok.all()) == (not dup)
                if dup:
                    oracle = _oracle_from_engine(dense, OracleIndexedTree)
                else:
                    wo = oracle.insert(v)
                    assert wo["ok"]
                    # the witness bundle must satisfy the verifier predicate
                    for w in (wd, ws):
                        ok = insert_leaf(
                            w.old_root, w.low_leaf_val, w.low_leaf_next_val,
                            w.low_leaf_next_idx, w.low_leaf_proof,
                            w.low_leaf_proof_helper, w.new_root,
                            w.new_leaf_val, w.new_leaf_next_val,
                            w.new_leaf_next_idx, w.new_leaf_index,
                            w.new_leaf_proof, w.new_leaf_proof_helper,
                            w.is_new_leaf_largest)
                        assert bool(np.asarray(ok).all()), (rnd, v)
                    inserted.append(v)
                budget -= 1
            else:                                 # non-inclusion queries
                qs = [rand_val() for _ in range(3)]
                w = dense.non_inclusion_witness(qs)
                expect = [q != 0 and q not in inserted for q in qs]
                assert w.ok.tolist() == expect, (rnd, qs, inserted)
            assert dense.get_root_int() == oracle.get_root(), rnd
            assert sparse.get_root_int() == oracle.get_root(), rnd

        # checkpoint round-trip preserves the root
        import tempfile
        path = os.path.join(tempfile.mkdtemp(), "t.npz")
        checkpoint.save(sparse, path)
        assert checkpoint.load(path).get_root_int() == oracle.get_root()
        print(f"round {rnd}: depth={depth} inserts={len(inserted)} OK",
              file=sys.stderr, flush=True)

    print(f"SOAK PASSED: {args.rounds} rounds in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
