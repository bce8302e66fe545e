"""Sharding the bootstrap over several devices (or virtual shards of one)."""

from . import mesh
