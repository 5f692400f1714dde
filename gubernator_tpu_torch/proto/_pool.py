"""The descriptor pool of the port's protobuf modules.

The port's ``gubernator.proto`` / ``peers.proto`` declare the same files
and package (``pb.gubernator``) as the JAX package's, so both cannot
register in protobuf's default pool of one process: the port's
generated modules add their descriptors to this private pool instead.
A process that imports both packages then holds two independent sets of
message classes with the same wire format.
"""
from google.protobuf import descriptor_pool

POOL = descriptor_pool.DescriptorPool()
