"""Native host code of the port (counterpart of `native/`): the exact
max-clique solver behind the serving path's clique prefilter."""
