"""The data layer: indices, samplers, media IO, the dataset, the pipeline."""
