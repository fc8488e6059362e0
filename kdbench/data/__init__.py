"""Generators of a configuration's points and query batches, one module
each, found by the name in the configuration's ``generator`` entry."""
