"""The benchmark of ``tpu_lutvq_torch``: one cell run once (``run.py``)."""
