"""The port's mesh layer: partition rules (``sharding``), layout hints
(``hints``) and the DTensor boundary helpers (``dtensor``), on
``torch.distributed``'s ``DeviceMesh`` and DTensor."""

from repro_torch.distributed import hints, sharding  # noqa: F401
