"""Named spans of the port's own work, on torch.profiler's clock.

``with span(INFER): ...`` marks a stretch of host code.  While a
torch.profiler session records (``torch.autograd._profiler_enabled()``),
the span is a ``torch.profiler.record_function("dv." + name)``: it lands in
the session's Chrome trace as a ``user_annotation`` event, on the clock of
the ``cpu_op``, ``cuda_runtime`` and ``kernel`` events, so a device
operation can be put down to the span that was open when its launch
started.  With no session recording, a span is one shared no-op context:
``record_function`` costs some 12 µs a span even then, the guard some
0.1 µs.  There is no switch: whoever profiles a call sees its spans.

The names, each covering:

* ``INFER``: a two-pass entry or a baseline pass (``eval/pipeline.py``),
  the whole host call;
* ``PREP``: pass 1, the DDIM model's volume and the conditioning latent
  (``acv_prep``, ``pcw_prep``, ``igev_prep``);
* ``FEATURES``: the folded paths' 2-D feature trunks
  (``models/acv_fold.py``, ``models/pcw_fold.py``), in both passes;
* ``REFINE``: PCW's 2-D refinement (``models/pcw_fold.py``), in pass 1
  and in every DDIM step;
* ``DDIM_STEP``: one iteration of the DDIM loop (``diffusion/ddim.py``);
* ``H2D``: an array built on the host and its copy to the tensor's device
  (``ops/regression.py``, ``diffusion/schedule.py``, ``diffusion/ddim.py``,
  ``ops/kernels/depthwise.py``);
* ``TRAIN_FORWARD``, ``TRAIN_BACKWARD``, ``TRAIN_OPTIMIZER``: a training
  step's forward and loss, its backward, its optimiser update
  (``train/loop.py``).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "dv."

INFER = "infer"
PREP = "prep"
FEATURES = "features"
REFINE = "refine"
DDIM_STEP = "ddim.step"
H2D = "h2d"
TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_OPTIMIZER = "train.optimizer"

NAMES = (INFER, PREP, FEATURES, REFINE, DDIM_STEP, H2D, TRAIN_FORWARD, TRAIN_BACKWARD,
         TRAIN_OPTIMIZER)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context for the span ``PREFIX + name``: a ``record_function`` while
    a profiler records, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
