"""A configuration's model family: the module that holds everything of the
benchmark that depends on the architecture.

A configuration file may carry "family"; without it the family is
"whisper". load(config) imports portbench/family_<family>.py by name, so a
new architecture is one new module (and its plain reference, a second one,
portbench/reference_<family>.py), with no edit to the runners.

A family module provides:

- dims(cfg): the widths of a configuration file, a dict of ints that the
  family's readers find as `window.n`; "V" is the vocabulary's rows.
- make_weights(cfg, seed, device, law=None): the weight tree the program's
  init is replaced by, made on the device from the seed; law: the traffic
  file's "weights" key.
- make_adapters(cfg, rank, alpha, seed, device, encoder=True): the adapter
  tree, likewise.
- leaves(tree): (path, leaf) of a tree, paths "/"-joined, keys sorted.
- train_steps(cfg, opts, seed, pool, rows, calib, device, lower=False,
  half_batch=False): the plain reference's checked training steps, a dict
  with "losses", "first_grad", "raw_grad", "change" (and "outlier_sets"
  where the base is int8), as train.compare reads it.
- served_gaps(cfg, seed, clips, tokens, n_forced, eot, device, lower=False,
  law=None): the plain reference's widest gap below the best logit of each
  served utterance's tokens.
- train_step_flops(n, batch, label_len, mode), encoder_flops(n, batch),
  cross_kv_flops(n, rows), decode_position_flops(n, rows, pos): useful
  FLOPs, from dims(cfg).
- injected(weights, adapters): a context manager in which the program's
  next build takes these trees in place of its random init.
- PREFIX, EOT: the token ids every transcript is forced to start with, and
  the end of text.
- reference_opts(args, seed): the reference's settings read from the
  program's parsed options; raises ValueError on an option the reference
  does not follow.
- check_program_settings(trainer, opts, check_steps): raises ValueError
  where the built program departs from what the reference follows.
- check_config(file_dict): raises ValueError where a configuration file
  does not hold the family's published shape (the manifest tests).
- port_matches(file_dict): whether the program builds the configuration
  as the file states it (the manifest tests).

The runners (train.py, transcribe.py, run.py) take these from the family
and keep the timing shared; each Window carries its family as
`window.family`. A family's per-layer readers compute their FLOPs and
bounds from its own module (through `window.family`, or by importing it),
never from another family's.
"""
from __future__ import annotations

import importlib
import re
from types import ModuleType
from typing import Any, Dict

DEFAULT = "whisper"
NAME = re.compile(r"^[a-z0-9_]{1,48}$")


def load(config: Dict[str, Any]) -> ModuleType:
    """The family module of a configuration file's dict."""
    name = config.get("family", DEFAULT)
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"a configuration's family is a lower-case name, not {name!r}")
    return importlib.import_module(f"portbench.family_{name}")
