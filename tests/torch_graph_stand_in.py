"""A stand-in for CUDA graphs on the CPU, for the port's tests.

`stand_in_graphs(pipe)` makes a CompiledPipeline admit nodes as on CUDA
(`_graphs`) and replaces its `_capture`: a "capture" runs the program body
once and keeps its input planes, and a "replay" runs the body again over
THOSE planes and copies its outputs into the first run's output tensors,
as a CUDA graph reads the addresses it captured and overwrites its
outputs. A count program's graph is stood in the same way; the planes it
hands an emit program (`xfer`) are that program's inputs like any other.
So a program whose inputs moved without a new capture would give the old
inputs' rows, as on the card.
"""

from query_engine_tpu_torch.engine.pipeline import _flat, _ptrs


def stand_in_graphs(pipe):
    pipe._graphs = True

    def capture(entry, planes, n_bufs, dyn_bufs, xfer=()):
        outputs = pipe._body(entry, planes, n_bufs, dyn_bufs, xfer)

        class Graph:
            def replay(self):
                new = pipe._body(entry, planes, n_bufs, dyn_bufs, xfer)
                for dst, src in zip(_flat(outputs), _flat(new)):
                    dst.copy_(src)

        entry.graph, entry.outputs = Graph(), outputs
        entry.planes, entry.xfer = planes, xfer
        entry.ptrs = _ptrs(planes, xfer)
        entry.n_bufs, entry.dyn_bufs = n_bufs, dyn_bufs
        pipe.stats["captures"] += 1

    pipe._capture = capture
