"""Halo exchange between the shards of a mesh."""
