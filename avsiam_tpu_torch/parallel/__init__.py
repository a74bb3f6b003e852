"""Data parallelism over ``torch.distributed``: the runtime helpers
(``dist``) and the data axis of the mesh (``mesh``)."""
