"""The plain reference the benchmark judges the program by: Ed25519 in
Python integers (``ed25519``), a decoder of the proposal frame written from
the wire format (``wire``) and the validator's acceptance rules
(``judge``). It imports nothing outside the standard library and this
folder."""
