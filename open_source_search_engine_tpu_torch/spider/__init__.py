"""Build plane: the link graph (linkdb). The crawler, its scheduler and
fetcher are not carried yet."""
