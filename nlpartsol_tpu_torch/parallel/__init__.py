"""Multi-device: the halo-sharded grid (``domain``) on ``torch.distributed``
(``collectives``, ``multihost``)."""
