"""Plain PyTorch references, one module per model family, in f32 with
TF32 off. They import nothing of the port: each module holds the family's
parameter layout (the tree the port's ``Model`` reads, which the
benchmark fills from the seed), its forward pass and what a cell compares
with it. ``precision`` picks the products' precision: "f32" is the
reference, "fp8" the control (every product's operands rounded to
float8 e4m3 with a per-tensor scale, the step below the bf16 the
configurations state)."""
import importlib


def family(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")
