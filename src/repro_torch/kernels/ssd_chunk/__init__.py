"""The Mamba-2 SSD intra-chunk kernel (``ssd_chunk.cu``), its plain
PyTorch version (``ref.py``) and the chunked SSD around it (``ops.py``)."""
