"""The mempool data plane of the port: so far only its batch frame tag and
the store key of an availability certificate (``messages``)."""
