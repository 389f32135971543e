"""The mempool data plane of the port: so far only the store key of an
availability certificate (``messages.cert_key``)."""
