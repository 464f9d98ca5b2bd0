from .pipeline import TokenStream, FileCorpus, make_batch_iterator  # noqa
