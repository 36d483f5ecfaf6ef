"""RPC layer: unary calls with msgpack message bodies over HTTP/1.1.

Mirrors the reference's RPC architecture (ref: weed/pb/) and the JAX
package's pb/: control and maintenance calls on their own port, HTTP for
the client data plane, and the port convention RPC port = HTTP port +
10000 (ref: weed/pb/grpc_client_server.go:119). Messages are msgpack
dicts with the JAX package's method names and fields. The wire is not
gRPC (pb/rpc.py): a port server and a JAX server cannot call each other.
"""

GRPC_PORT_OFFSET = 10000


def grpc_address(http_address: str) -> str:
    """host:port -> host:(port+10000), the RPC address of an HTTP server
    (ref grpc_client_server.go:119-140)."""
    host, _, port = http_address.rpartition(":")
    return f"{host}:{int(port) + GRPC_PORT_OFFSET}"


def http_address(grpc_addr: str) -> str:
    """Inverse of grpc_address: the HTTP hostport, the canonical peer
    identity."""
    host, _, port = grpc_addr.rpartition(":")
    return f"{host}:{int(port) - GRPC_PORT_OFFSET}"
