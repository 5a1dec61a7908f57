"""The dense GQA transformer, its layers and the model zoo."""
