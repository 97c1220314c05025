"""Radius-sweep benchmark harness (the reference's ``tc``/``ts`` pair)."""

from .harness import (
    TrafficLoad,
    DurationClient,
    DurationServer,
    parse2csv_client_leg,
    parse2csv_client_opt,
    parse2csv_server_leg,
    parse2csv_server_opt,
)

__all__ = [
    "TrafficLoad",
    "DurationClient",
    "DurationServer",
    "parse2csv_client_leg",
    "parse2csv_client_opt",
    "parse2csv_server_leg",
    "parse2csv_server_opt",
]
