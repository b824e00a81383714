"""Exchange-site registry: the declared cross-client communication surface.

A copy of `repro.analysis.registry.exchange_site`. DPFL's isolation
claim is that clients see peers only through the budgeted Eq.-4 exchange
and the GGC refresh. fedlint (rule F1, ``python -m repro.analysis.lint
--rules F``) reads every file under ``src/`` and flags a cross-client
mixing primitive (``graph_mix``, a client-contracting einsum) that no
``@exchange_site`` encloses; it matches the decorator by name, so the
port's own copy satisfies it.

``charges`` documents where the moved bytes are accounted (rule F2):
``"caller"`` (a mixing helper; the calling aggregate charges the
downloads), ``"preprocess"`` (charged by `core.dpfl._comm_preprocess`),
``"unaccounted"``. A bare ``@exchange_site`` asserts that the body itself
updates a comm counter.

The decorator is a runtime passthrough: it tags the function and records
it, and wraps nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["ExchangeSite", "EXCHANGE_SITES", "exchange_site",
           "is_exchange_site"]


@dataclasses.dataclass(frozen=True)
class ExchangeSite:
    """One registered cross-client exchange point."""
    name: str
    qualname: str
    module: str
    charges: Optional[str] = None   # None = the body updates a counter


#: module.qualname -> ExchangeSite, filled at import time by the decorator
#: (`repro_torch.fl.round_engine.make_round_step` warns when an aggregate
#: is neither registered nor reaches a registered function)
EXCHANGE_SITES: Dict[str, ExchangeSite] = {}


def exchange_site(fn=None, *, charges: Optional[str] = None):
    """Declare ``fn`` (and everything lexically nested in it) a
    legitimate cross-client exchange point. Returns ``fn`` itself with an
    ``__exchange_site__`` tag and a registry entry."""

    def register(f):
        site = ExchangeSite(
            name=f.__name__,
            qualname=getattr(f, "__qualname__", f.__name__),
            module=getattr(f, "__module__", "?"),
            charges=charges)
        EXCHANGE_SITES[f"{site.module}.{site.qualname}"] = site
        f.__exchange_site__ = site
        return f

    if fn is None:
        return register
    return register(fn)


def is_exchange_site(fn) -> bool:
    """True iff ``fn`` carries the ``@exchange_site`` tag."""
    return getattr(fn, "__exchange_site__", None) is not None
