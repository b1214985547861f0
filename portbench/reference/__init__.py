"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch in float64 (or in bfloat16 for the control). It imports
neither ``jax`` nor either patolette package and takes nothing the program
made but the outputs it judges.
"""
