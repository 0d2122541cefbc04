"""A stand-in for CUDA graphs on the CPU, for the port's tests.

`stand_in_graphs(pipe)` makes a CompiledPipeline admit nodes as on CUDA
(`_graphs`) and replaces its `_capture`: a "capture" runs the program body
once and keeps its input planes, and a "replay" runs the body again over
THOSE planes and copies its outputs into the first run's output tensors,
as a CUDA graph reads the addresses it captured and overwrites its
outputs. So a program whose inputs moved without a new capture would give
the old inputs' rows, as on the card.
"""

from query_engine_tpu_torch.engine.pipeline import _ptrs


def _flat(outputs):
    datas, valids, sel, count = outputs
    return list(datas) + list(valids) + [sel, count]


def stand_in_graphs(pipe):
    pipe._graphs = True

    def capture(entry, planes, n_bufs, dyn_bufs):
        outputs = pipe._body(entry, planes, n_bufs, dyn_bufs)

        class Graph:
            def replay(self):
                new = pipe._body(entry, planes, n_bufs, dyn_bufs)
                for dst, src in zip(_flat(outputs), _flat(new)):
                    dst.copy_(src)

        entry.graph, entry.outputs = Graph(), outputs
        entry.planes, entry.ptrs = planes, _ptrs(planes)
        entry.n_bufs, entry.dyn_bufs = n_bufs, dyn_bufs
        pipe.stats["captures"] += 1

    pipe._capture = capture
