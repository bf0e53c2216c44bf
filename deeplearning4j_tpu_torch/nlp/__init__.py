"""NLP: embeddings (Word2Vec/GloVe/ParagraphVectors) + text pipeline, on
the card.

Mirror of reference deeplearning4j-scaleout/deeplearning4j-nlp (SURVEY.md
§2.8): SequenceVectors engine, Word2Vec skip-gram with hierarchical
softmax + negative sampling, vocabulary construction with Huffman coding,
tokenizers/sentence iterators, vector serialization. The port of
``deeplearning4j_tpu/nlp``: the reference's Hogwild threads racing on
shared syn0/syn1 tables become batched synchronous updates — pairs mined
on the host into index arrays, each batch one gather/scatter-add update
of tables on the device, a chunk of batches one captured CUDA graph
(``sequence_vectors.py``).
"""

from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator,
    FileSentenceIterator,
    LineSentenceIterator,
)
