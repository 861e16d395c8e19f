"""Inter-node transport (TransportService analog over asyncio TCP)."""

from .service import (
    ConnectTransportError,
    ReceiveTimeoutTransportError,
    RemoteTransportError,
    TransportError,
    TransportService,
)

__all__ = [
    "TransportService",
    "TransportError",
    "ConnectTransportError",
    "ReceiveTimeoutTransportError",
    "RemoteTransportError",
]
