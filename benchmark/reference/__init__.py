"""The benchmark's plain reference: one step of the engine in plain
PyTorch (`step.step`), the spawn scenes rebuilt from the seed
(`spawn`), and the comparison that decides a run's `correct`
(`compare`).

It imports nothing of the program and no JAX. Its step is a frozen copy
of the port's plain twins: a change to the program leaves it as it is.
"""
