"""Sharding the bootstrap over several devices (or virtual shards of one),
over the coefficient axis, and over several processes."""

from . import dist_ntt, dryrun, mesh, multihost
