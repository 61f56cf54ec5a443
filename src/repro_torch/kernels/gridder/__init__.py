"""GRIDDER and DEGRIDDER, the image-domain-gridding pair of the paper's
Fig. 2: visibilities onto subgrid pixels and back."""
