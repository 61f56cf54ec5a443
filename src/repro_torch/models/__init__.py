"""The port's models: layers, attention, blocks, and the serve steps."""
