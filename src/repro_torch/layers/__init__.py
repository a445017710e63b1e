"""LM layers (the reference's ``layers/``): plain functions over parameter
dicts whose keys follow the reference's parameter paths."""
