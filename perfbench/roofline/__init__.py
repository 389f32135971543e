"""The roofline of the certificate checks: operations and bytes of the
batch equation and the card's peaks (``model``)."""
