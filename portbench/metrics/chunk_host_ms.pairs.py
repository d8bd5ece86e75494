"""chunk_host_ms.pairs (ms): the median over the traced window's chunks of
a chunk's summed fill, dispatch, unpack and present spans
(`pathfinder.chunk.*`, the wait on its result left out): the main
thread's host work a chunk."""

from portbench.harness.spans import host_ms_per_key

NAMES = ("pathfinder.chunk.fill", "pathfinder.chunk.dispatch", "pathfinder.chunk.unpack",
         "pathfinder.chunk.present")


def read(r):
    return host_ms_per_key(r, NAMES, "pathfinder.chunk.dispatch")
