"""Benchmark structs + CSV emitters, schema-compatible with the reference.

Column names and orders replicate ``include/benchmark.h:109-314`` exactly so
downstream analysis of ``client_leg.csv``/``client_opt.csv``/
``server_leg.csv``/``server_opt.csv`` is drop-in. Durations are nanoseconds,
traffic is bytes.

Note: the reference's ``d_kGen`` is (buggily) taken from the decrypt interval
(``test_client.cc:227``, SURVEY.md §4 quirks); here it measures key
generation. The column name and position are unchanged.

Copy of ``pplp_tpu.benchmark.harness``: the same columns, strings and files.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from ..utils.csvwriter import CSVWriter

__all__ = [
    "TrafficLoad",
    "DurationClient",
    "DurationServer",
    "parse2csv_client_leg",
    "parse2csv_client_opt",
    "parse2csv_server_leg",
    "parse2csv_server_opt",
]


@dataclass
class TrafficLoad:
    c_sendParms: int = 0
    c_sendPk: int = 0
    c_sendCips: int = 0
    c_recvBF: int = 0
    c_recvBD: int = 0
    c_totalSend: int = 0
    c_totalRecv: int = 0
    c_total: int = 0


@dataclass
class DurationClient:
    d_setParms: int = 0
    d_kGen: int = 0
    d_enc: int = 0
    d_sendPk: int = 0
    d_sendParms: int = 0
    d_sendCip: int = 0
    d_recvBF: int = 0
    d_recvBD: int = 0
    d_dec: int = 0
    d_stage1: int = 0
    d_stage2: int = 0
    d_stage3: int = 0
    d_total: int = 0
    d_totalCalc: int = 0
    d_totalTraffic: int = 0


@dataclass
class DurationServer:
    d_recvParms: int = 0
    d_recvPk: int = 0
    d_setParms: int = 0
    d_setBF: int = 0
    d_sendBF: int = 0
    d_recvCips: int = 0
    d_homoCalc: int = 0
    d_sendBD: int = 0
    d_stage1: int = 0
    d_stage2: int = 0
    d_stage3: int = 0
    d_total: int = 0
    d_totalTraffic: int = 0
    d_totalCalc: int = 0


_CLIENT_LEG_COLS = [
    "d_setParms", "d_kGen", "d_sendPk", "d_sendParms", "d_recvBF", "d_enc",
    "d_sendCip", "d_recvBD", "d_dec", "d_stage1", "d_stage2", "d_stage3",
    "d_total", "d_totalCalc", "d_totalTraffic",
]
_CLIENT_OPT_COLS = [
    "d_setParms", "d_sendParms", "d_kGen", "d_enc", "d_sendCip", "d_recvBF",
    "d_recvBD", "d_dec", "d_stage1", "d_stage2", "d_stage3", "d_total",
    "d_totalCalc", "d_totalTraffic",
]
_TRAFFIC_COLS = [
    "c_sendParms", "c_sendPk", "c_sendCips", "c_recvBF", "c_recvBD",
    "c_totalSend", "c_totalRecv", "c_total",
]
_SERVER_LEG_COLS = [
    "d_recvParms", "d_recvPk", "d_setParms", "d_setBF", "d_sendBF",
    "d_recvCips", "d_homoCalc", "d_sendBD", "d_stage1", "d_stage2",
    "d_stage3", "d_total", "d_totalTraffic", "d_totalCalc",
]
_SERVER_OPT_COLS = [
    "d_recvParms", "d_setParms", "d_setBF", "d_recvCips", "d_homoCalc",
    "d_sendBF", "d_sendBD", "d_stage1", "d_stage2", "d_stage3", "d_total",
    "d_totalTraffic", "d_totalCalc",
]


def _emit(filename, radius, makehead, cols, *records):
    csv = CSVWriter(",")
    if makehead:
        csv.new_row().add("radius")
        for c in cols:
            csv.add(c)
    csv.new_row().add(radius)
    merged = {}
    for rec in records:
        merged.update({f.name: getattr(rec, f.name) for f in fields(rec)})
    for c in cols:
        csv.add(merged[c])
    csv.write_to_file(filename, append=not makehead)


def parse2csv_client_leg(filename, radius, makehead, traffic: TrafficLoad, dur: DurationClient):
    _emit(filename, radius, makehead, _CLIENT_LEG_COLS + _TRAFFIC_COLS, dur, traffic)


def parse2csv_client_opt(filename, radius, makehead, traffic: TrafficLoad, dur: DurationClient):
    _emit(filename, radius, makehead, _CLIENT_OPT_COLS + _TRAFFIC_COLS, dur, traffic)


def parse2csv_server_leg(filename, radius, makehead, dur: DurationServer):
    _emit(filename, radius, makehead, _SERVER_LEG_COLS, dur)


def parse2csv_server_opt(filename, radius, makehead, dur: DurationServer):
    _emit(filename, radius, makehead, _SERVER_OPT_COLS, dur)
