"""Host-side helpers: the depth colormap."""
