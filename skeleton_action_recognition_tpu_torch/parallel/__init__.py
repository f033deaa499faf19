"""Data parallelism across processes, one per card (``distributed``:
the process group; ``sharding``: ``DataParallel``), and host-to-device
input staging."""
