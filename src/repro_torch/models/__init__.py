"""The paper's small CNN/MLP classifiers."""
