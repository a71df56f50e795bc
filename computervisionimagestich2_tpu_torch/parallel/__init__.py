"""Batches of independent panoramas and registration pairs (counterpart of
``computervisionimagestich2_tpu.parallel``, BASELINE.json config 3).

``batched.py`` holds ``batched_project_and_extract``,
``batched_pairwise_register`` and ``batched_stitch_chain``; they are
exposed here lazily, so importing the package loads no model code. The
JAX package's mesh code (``shard_batch``, ``make_mesh``, the sharded blur
and blends: ROADMAP.md A18) is not ported: the port runs on one card.
"""

_BATCHED = ("batched_pairwise_register", "batched_project_and_extract",
            "batched_stitch_chain")


def __getattr__(name):
    if name in _BATCHED:
        from . import batched

        return getattr(batched, name)
    raise AttributeError(name)
