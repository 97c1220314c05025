"""The proximity protocol: configuration, stages, roles and the local demo."""

from .config import ProtocolConfig
from .demo import DemoResult, run_local_demo
from .roles import ProximityClient, ProximityServer

__all__ = ["ProtocolConfig", "DemoResult", "run_local_demo", "ProximityClient",
           "ProximityServer"]
