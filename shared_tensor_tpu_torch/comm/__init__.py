"""The peer tier: wire format, TCP transport and the peer."""
