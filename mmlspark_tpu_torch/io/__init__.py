"""IO & services layer: HTTP-on-X, serving, binary ingestion, PowerBI.

The port's counterpart of ``mmlspark_tpu/io``, with the same exported
names (reference: io/http, injected streaming serving sources, io/binary,
io/powerbi — SURVEY.md §1 L5)."""

from .binary import read_binary_file, read_binary_files
from .http import (AsyncHTTPClient, CustomInputParser, CustomOutputParser,
                   HTTPRequestData, HTTPResponseData, HTTPTransformer,
                   JSONInputParser, JSONOutputParser, PartitionConsolidator,
                   SharedVariable, SimpleHTTPTransformer,
                   SingleThreadedHTTPClient, StringOutputParser,
                   advanced_handling, send_request)
from .port_forwarding import PortForwarder, ssh_forward
from .powerbi import PowerBIWriter, write_to_powerbi
from .serving import (ServedRequest, ServingBuilder, ServingQuery,
                      ServingServer, make_reply, requests_to_dataset, serve)

__all__ = [
    "AsyncHTTPClient", "CustomInputParser", "CustomOutputParser",
    "HTTPRequestData", "HTTPResponseData", "HTTPTransformer",
    "JSONInputParser", "JSONOutputParser", "PartitionConsolidator",
    "PortForwarder", "PowerBIWriter", "ServedRequest", "ServingBuilder",
    "ServingQuery", "ServingServer", "SharedVariable",
    "SimpleHTTPTransformer", "SingleThreadedHTTPClient",
    "StringOutputParser", "advanced_handling", "make_reply",
    "read_binary_file", "read_binary_files", "requests_to_dataset",
    "send_request", "serve", "ssh_forward", "write_to_powerbi",
]
