"""Data parallelism over ranks: the mesh (``mesh.py``) and the replicated
source layout (``dp.py``)."""
