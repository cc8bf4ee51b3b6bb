"""Cognitive service transformers (reference: cognitive/ — SURVEY.md §2c).

The port's copy of ``mmlspark_tpu/cognitive``: host clients of REST
services, with no device work. All services compose the port's io.http
machinery; see base.CognitiveServicesBase.
"""

from .base import (CognitiveServicesBase, PollingCognitiveService,
                   ServiceParam)
from .speech_sdk import (CompressedStream, SpeechToTextSDK, WavStream,
                         open_audio_stream, stream_recognize)
from .services import (OCR, NER, AddDocuments, AnalyzeImage,
                       AzureSearchWriter, BingImageSearch, DescribeImage,
                       DetectAnomalies, DetectFace, DetectLastAnomaly,
                       EntityDetector, EntityDetectorV2, FindSimilarFace,
                       GenerateThumbnails, GroupFaces, IdentifyFaces,
                       KeyPhraseExtractor, KeyPhraseExtractorV2,
                       LanguageDetector, LanguageDetectorV2, NERV2,
                       RecognizeDomainSpecificContent, RecognizeText,
                       SimpleDetectAnomalies, SpeechToText, TagImage,
                       TextSentiment, TextSentimentV2, VerifyFaces)

__all__ = [
    "CompressedStream", "SpeechToTextSDK", "WavStream",
    "open_audio_stream", "stream_recognize",
    "AddDocuments", "AnalyzeImage", "AzureSearchWriter", "BingImageSearch",
    "CognitiveServicesBase", "DescribeImage", "DetectAnomalies", "DetectFace",
    "DetectLastAnomaly", "EntityDetector", "EntityDetectorV2", "FindSimilarFace",
    "GenerateThumbnails", "GroupFaces", "IdentifyFaces", "KeyPhraseExtractor",
    "KeyPhraseExtractorV2", "LanguageDetector", "LanguageDetectorV2", "NER",
    "NERV2", "OCR", "PollingCognitiveService",
    "RecognizeDomainSpecificContent", "RecognizeText", "ServiceParam",
    "SimpleDetectAnomalies", "SpeechToText", "TagImage", "TextSentiment",
    "TextSentimentV2", "VerifyFaces",
]
