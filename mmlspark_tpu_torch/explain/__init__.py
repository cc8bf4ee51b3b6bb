"""Model explanations (counterpart of ``mmlspark_tpu/explain``)."""
