"""Writes ``tests/fixtures/orbax_numbered/``: an orbax checkpoint directory
whose OCDBT database tensorstore wrote with a numbered manifest
(``{"driver": "ocdbt", "config": {"manifest_kind": "numbered"}}``):
``manifest.ocdbt`` holds the config alone, each commit a
``manifest.<16 hex digits>``.

JAX's ``save_pytree_orbax`` saves two trees of one structure (a bf16 leaf,
a float32 leaf sharded over 4 CPU devices, so stored as 4 zarr chunks, a
vector and a scalar) into temporary directories.  Tensorstore then copies
every key of the first save's database into a new numbered database in one
transaction (generation 1), and every key of the second save's in another
(generation 2), and the orbax metadata files of the second save beside it.
So the newest version holds the second tree and an older one the first.

    JAX_PLATFORMS=cpu python tests/make_orbax_numbered_fixture.py

Generated once and committed; the tests only read it.
"""

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "fixtures", "orbax_numbered")
DB_FILES = ("manifest.ocdbt", "d", "ocdbt.process_0")


def _tree(seed: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    rng = np.random.default_rng(seed)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    sharded = jax.device_put(rng.normal(size=(64, 24)).astype(np.float32),
                             NamedSharding(mesh, PartitionSpec("data", None)))
    return {"params": {"w_bf16": jnp.asarray(rng.normal(size=(40, 24)), jnp.bfloat16),
                       "w_sharded": sharded,
                       "bias": jnp.asarray(rng.normal(size=(24,)), jnp.float32)},
            "step": jnp.asarray(seed, jnp.int32)}


def _copy_keys(src: str, dst) -> None:
    """Every key of the OCDBT database at ``src`` into ``dst`` (a kvstore)
    in one transaction: one commit."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{src}/"}).result()
    txn = ts.Transaction()
    out = dst.with_transaction(txn)
    for key in kv.list().result():
        out.write(key, kv.read(key).result().value).result()
    txn.commit_async().result()


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    import tensorstore as ts

    from vla_touch_tpu.utils.checkpoint import save_pytree_orbax

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    dst = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{OUT}/",
                           "config": {"manifest_kind": "numbered"}}).result()
    with tempfile.TemporaryDirectory() as tmp:
        for seed in (1, 2):
            src = os.path.join(tmp, f"save{seed}")
            save_pytree_orbax(src, _tree(seed))
            _copy_keys(src, dst)
        for name in sorted(os.listdir(src)):
            if name in DB_FILES:
                continue
            path = os.path.join(src, name)
            (shutil.copytree if os.path.isdir(path) else shutil.copy)(
                path, os.path.join(OUT, name))
    print("\n".join(sorted(os.listdir(OUT))), file=sys.stderr)


if __name__ == "__main__":
    main()
