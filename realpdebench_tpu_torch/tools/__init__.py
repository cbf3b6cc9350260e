"""Offline tools of the port (``convert_hdf5_to_hf``)."""
