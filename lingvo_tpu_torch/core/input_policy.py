"""Input-placement policy (port of lingvo_tpu/core/input_policy.py).

The reference stamps each host's shard into an input generator's params
on multi-host runs. The port runs one process, so `Apply` returns the
params as they are; a multi-host request raises until the parallelism
slice (ROADMAP item 11) ports the cluster.
"""

from __future__ import annotations


def Apply(input_params, num_hosts: int = 1):
  """input_params as this process's share of the input: all of it."""
  if num_hosts > 1:
    raise NotImplementedError(
        "multi-host input sharding comes with the parallelism slice "
        "(ROADMAP item 11)")
  return input_params


def Instantiate(input_params):
  """The one place input params become a generator."""
  return Apply(input_params).Instantiate()
