"""Batches and device meshes (counterpart of
``computervisionimagestich2_tpu.parallel``).

- ``batched.py``: ``batched_project_and_extract``,
  ``batched_pairwise_register`` and ``batched_stitch_chain`` (BASELINE.json
  config 3), and ``shard_batch``, which splits a batch over a mesh's
  ``data`` devices;
- ``mesh.py``: ``make_mesh``, a (data, sp) grid of devices driven by one
  process; a list of devices that repeats one is a virtual mesh, as the
  JAX tests' virtual CPU devices;
- ``spatial.py``: ``sharded_gaussian_blur``, rows sharded over ``sp`` with
  a halo exchange;
- ``blend.py``: ``sharded_composite``, ``sharded_blend_two_images`` and
  ``sharded_composite_and_blend``, one stitch edge with its canvas rows
  sharded over ``sp`` (``Stitcher(mesh=...)``, ``panorama-torch --sp N``).

The names are exposed lazily, so importing the package loads no model code.
"""

_EXPORTS = {
    "batched_pairwise_register": "batched",
    "batched_project_and_extract": "batched",
    "batched_stitch_chain": "batched",
    "shard_batch": "batched",
    "make_mesh": "mesh",
    "sharded_gaussian_blur": "spatial",
    "sharded_composite": "blend",
    "sharded_composite_and_blend": "blend",
    "sharded_blend_two_images": "blend",
}


def __getattr__(name):
    if name in _EXPORTS:
        from importlib import import_module

        return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(name)
