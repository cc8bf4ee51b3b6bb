"""Multi-process training on ``torch.distributed``: the mesh of named axes
(:mod:`.mesh`: ``data``, ``seq``, ``model``), its differentiable
collectives (:mod:`.collectives`), sequence-parallel attention (the ring
and its zig-zag layout in :mod:`.ring_attention`, Ulysses in
:mod:`.ulysses`), process start-up and barriers (:mod:`.distributed`) and
the placement decisions (:mod:`.placement`). Counterpart of
``mmlspark_tpu/parallel/`` (its ``compat`` shim has none: there is no
``shard_map`` to bridge)."""
