"""The JAX package's examples (``examples/*.py``) on the port.

One module per example, each the counterpart of ``examples/<name>.py``
with that file's function names, runnable as
``python -m gt4py_tpu_torch.examples.<name> [backend]``. Each takes
``backend`` and ``device`` arguments: the default is ``cuda:hopper`` on
the card; ``device="cpu"`` runs the kernels' plain version on CPU tensors.
Sizes are arguments too, defaulting to the JAX example's. A kernel
example's ``run`` or ``main`` also takes ``stencils``: what its
``make_stencils`` (``make_diagnostics``, or the operator) built, to reuse.

The modules, and the kernel each runs on the card:

- ``tridiagonal_solver``: ``column``;
- ``lap_cartesian_vs_next``: ``plane``, the stencil and the field operator;
- ``burgers``: ``plane``;
- ``isentropic_diagnostics``: ``column``;
- ``implicit_vertical_diffusion``: ``column``, through the bridge;
- ``shallow_water``: none (staggered fields run embedded);
- ``typed_operators``: ``fused_plane`` (its Laplacian on 2-D fields);
- ``custom_backend``: ``fused_plane`` (a 1-D field);
- ``distributed_hdiff``: ``plane`` on every shard of a mesh of devices
  (``devices``, default four shards on one card, in place of ``device``),
  and the Laplacian on ``fused_plane``.
"""


def field_device(backend, device):
    """Where a field-view example allocates: ``device`` if given, else the
    CPU for the ``numpy`` oracle (it runs on the host) and the card for
    every other backend."""
    if device is not None:
        return device
    return "cpu" if getattr(backend, "name", backend) == "numpy" else "cuda"
