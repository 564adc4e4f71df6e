"""Launchers of the port: `serve` (LM and BPMF serving), `train` (BPMF
training; LM training as a library), `dryrun` and `bpmf_dryrun` (the
meta device's sweep under the cost model `cost`), `mesh` (the meshes,
the serving tier's host devices and the card's peaks) and `profile` (the
card's measurement helpers)."""
