
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
from imt_tpu.utils.cache import setup_compile_cache
setup_compile_cache()
import random
from imt_tpu.tree.sparse import SparseIndexedMerkleTree
from imt_tpu.utils import checkpoint

ckpt, progress, seed, k, n_batches = (
    sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]))
rng = random.Random(seed)
stream = [rng.randrange(1, 1 << 250) for _ in range(k * n_batches)]
t = SparseIndexedMerkleTree(16, initial_capacity_log2=4)
for b in range(n_batches):
    ok = t.insert_batch(stream[b * k:(b + 1) * k])
    assert ok.all(), b
    checkpoint.save(t, ckpt)              # atomic write-temp + rename
    with open(progress + ".tmp", "w") as f:
        f.write(str(b + 1))
    os.replace(progress + ".tmp", progress)
print("WORKER-DONE", flush=True)
