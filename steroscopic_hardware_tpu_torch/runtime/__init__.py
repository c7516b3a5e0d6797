"""Serving runtime: depth pipeline, HTTP server, frame sources, and the
port's copies of the frame bus, camera manager, logger, wire protocol and
emitter."""
