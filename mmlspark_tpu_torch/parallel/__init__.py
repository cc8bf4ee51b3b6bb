"""Multi-process GBDT training on ``torch.distributed``: the data group
(:mod:`.mesh`), process start-up and barriers (:mod:`.distributed`) and
the placement decisions (:mod:`.placement`). Counterpart of
``mmlspark_tpu/parallel/`` for the data axis; the ``model`` and ``seq``
axes (ring attention, Ulysses) are not ported yet."""
