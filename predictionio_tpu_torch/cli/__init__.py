"""The port's ``pio`` console (reference: tools/.../tools/console/)."""
