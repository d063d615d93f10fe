"""FCDRAM core of the port (see ``repro.core`` for the reference).

device, analog, decoder — host-side models, copied from the reference
simulator  — trial-batched bank with its cell state on the device
isa        — PuD instructions over the torch bank
bankarray  — per-bank chips behind one device-addressed API, cross-bank
             reduction tree
charz      — the characterization: the Monte-Carlo (Figs. 7 / 15, Obs. 3,
             programs and workloads) and the closed-form figure drivers
calibrate  — the analog model's fit to the paper's claims (copied)
reliability — replica planning over the calibrated model and the MC
compiler   — Boolean-expression compiler: DSL, lowering, oracle, run_sim and
             the resident planner / executor
policy     — ResidentPolicy + EngineConfig (copied from the reference)
analog_torch — closed-form tables and one-call samplers on torch
"""
