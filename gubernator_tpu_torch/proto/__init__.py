"""The port's copies of the wire schema (gubernator.proto, peers.proto)
and their generated modules, registered in a private descriptor pool
(_pool.py).  Nothing is imported here: protobuf loads only with the
modules that need it."""
