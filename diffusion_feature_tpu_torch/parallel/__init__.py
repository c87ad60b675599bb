"""Several GPUs: the dp/sp/tp mesh over ``torch.distributed``
(``parallel/mesh.py``)."""
