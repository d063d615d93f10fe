"""FCDRAM core of the port (see ``repro.core`` for the reference).

device, analog, decoder — host-side models, copied from the reference
simulator  — trial-batched bank with its cell state on the device
isa        — PuD instructions over the torch bank
bankarray  — per-bank chips behind one device-addressed API
charz      — the Monte-Carlo characterization (Figs. 7 / 15)
compiler   — Boolean-expression compiler, front half (DSL, lowering, oracle)
policy     — ResidentPolicy + EngineConfig (copied from the reference)
analog_torch — closed-form tables and one-call samplers on torch
"""
