"""The proximity protocol: configuration, stages, roles, the local demo, the
TCP transport (``transport``) and the networked client and server
(``netmain``)."""

from .config import ProtocolConfig
from .demo import DemoResult, run_local_demo
from .roles import ProximityClient, ProximityServer

__all__ = ["ProtocolConfig", "DemoResult", "run_local_demo", "ProximityClient",
           "ProximityServer"]
