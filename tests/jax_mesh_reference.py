"""The JAX reference's mesh training on two forced host devices, for the
two-rank cases of ``tests/test_torch_mesh.py``.

XLA reads ``XLA_FLAGS`` once, when JAX starts, so the reference's
two-device mesh needs a process of its own: the test runs this file as a
script (``python tests/jax_mesh_reference.py ARCH COMPRESSED N_PARTS
N_EPOCHS OUT``), which forces two host devices before it imports JAX,
trains ``repro.graph.train.train_gnn_mesh`` on a ``graph`` mesh of both
(``impl="jnp"``, the reference's weights from ``PRNGKey(0)``) on the test
graph of ``tests/torch_mesh_ranks.py``, and saves each epoch's loss and
the final parameters (``w{layer}``, ``b{layer}``) to the ``.npz`` OUT.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.core.compressor import CompressionConfig  # noqa: E402
from repro.graph import data  # noqa: E402
from repro.graph.models import GNNConfig  # noqa: E402
from repro.graph.train import train_gnn_mesh  # noqa: E402

INT2 = CompressionConfig(bits=ranks.INT2.bits,
                         group_size=ranks.INT2.group_size,
                         rp_ratio=ranks.INT2.rp_ratio)


def main(arch: str, compressed: str, n_parts: str, n_epochs: str,
         out: str) -> None:
    g = data.synthetic_graph(*ranks.GRAPH_ARGS, **ranks.GRAPH_KW)
    cfg = GNNConfig(arch=arch, hidden=(32,), n_classes=5,
                    compression=INT2 if compressed == "1" else None)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("graph",))
    res = train_gnn_mesh(g, cfg, int(n_parts), n_epochs=int(n_epochs),
                         seed=0, mesh=mesh, impl="jnp", verbose=True,
                         eval_every=1)
    if res["mesh_devices"] != 2:
        raise RuntimeError(f"the reference ran on {res['mesh_devices']} "
                           "devices, not 2")
    arrays = {"losses": np.asarray([h[1] for h in res["history"]])}
    for li, p in enumerate(res["params"]):
        arrays[f"w{li}"] = np.asarray(p["w"])
        arrays[f"b{li}"] = np.asarray(p["b"])
    np.savez(out, **arrays)


if __name__ == "__main__":
    main(*sys.argv[1:])
