"""Native runtime components (C++): the TCP window service."""

from .tcp_window_service import TcpEndpoint, TcpMailbox, TcpWindowFabric

__all__ = ["TcpEndpoint", "TcpMailbox", "TcpWindowFabric"]
