"""Runtime analysis of the port (port of `repro.analysis`, DESIGN.md §13,
§14):

* :mod:`repro_torch.analysis.registry` — the ``@exchange_site`` decorator
  declaring the cross-client communication surface (fedlint's rule F1
  reads it by name).
* :mod:`repro_torch.analysis.guards` — runtime guards: ``no_transfer()``
  regions, ``recompile_sentinel()`` build-and-load assertions, and the
  ``donation_report()`` audit.
* :mod:`repro_torch.analysis.commaudit` — the wire-bytes audit: one
  round's collective calls, classified and reconciled against the
  claimed ``DPFLResult.comm_bytes``.

`repro`'s static linters (``tracelint``, ``fedlint``, ``lint``) read
source files and run on the port's as they are; they have no port.
Submodules load lazily through module ``__getattr__``, as `repro`'s do.
"""

_GUARD_EXPORTS = (
    "no_transfer", "allow_transfers", "recompile_sentinel",
    "RecompileError", "TransferError", "donation_report",
)
_REGISTRY_EXPORTS = ("exchange_site", "is_exchange_site", "EXCHANGE_SITES",
                     "ExchangeSite")

__all__ = (["registry", "guards", "commaudit"] + list(_GUARD_EXPORTS)
           + list(_REGISTRY_EXPORTS))


def __getattr__(name):
    import importlib
    if name in ("guards", "registry", "commaudit"):
        return importlib.import_module(f".{name}", __name__)
    if name in _GUARD_EXPORTS:
        return getattr(importlib.import_module(".guards", __name__), name)
    if name in _REGISTRY_EXPORTS:
        return getattr(importlib.import_module(".registry", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
