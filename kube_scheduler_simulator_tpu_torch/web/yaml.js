// Minimal YAML codec for k8s manifests (the web UI's monaco-YAML
// analogue; reference UI edits resources as YAML via vue-monaco,
// web/components/*.vue).  Supports the manifest subset: block maps,
// block sequences, flow [] / {} on one line, quoted + plain scalars,
// comments, and multi-line strings via | and |- literals.  Round-trip
// is JSON-faithful: dump(parse(dump(x))) === dump(x).
"use strict";

const YAML = (() => {
  // ---------------------------------------------------------------- dump
  const PLAIN_OK = /^[A-Za-z0-9_][A-Za-z0-9_.\/-]*$/;

  function scalar(v) {
    if (v === null) return "null";
    if (typeof v === "number" || typeof v === "bigint") return String(v);
    if (typeof v === "boolean") return v ? "true" : "false";
    const s = String(v);
    if (s === "") return '""';
    if (PLAIN_OK.test(s) &&
        !["null", "true", "false", "yes", "no", "on", "off"].includes(s.toLowerCase()) &&
        !/^[\d.+-]/.test(s)) {
      return s;
    }
    return JSON.stringify(s);
  }

  function dump(v, indent) {
    indent = indent || 0;
    const pad = "  ".repeat(indent);
    if (Array.isArray(v)) {
      if (!v.length) return pad + "[]";
      return v.map((item) => {
        if (item !== null && typeof item === "object" && Object.keys(item).length) {
          const body = dump(item, indent + 1);
          return pad + "-" + body.slice(pad.length + 1);
        }
        return pad + "- " + (item !== null && typeof item === "object" ? (Array.isArray(item) ? "[]" : "{}") : scalar(item));
      }).join("\n");
    }
    if (v !== null && typeof v === "object") {
      const keys = Object.keys(v);
      if (!keys.length) return pad + "{}";
      return keys.map((k) => {
        const val = v[k];
        const key = PLAIN_OK.test(k) ? k : JSON.stringify(k);
        if (val !== null && typeof val === "object" && Object.keys(val).length) {
          return pad + key + ":\n" + dump(val, indent + 1);
        }
        if (typeof val === "string" && val.includes("\n")) {
          const block = val.endsWith("\n") ? "|" : "|-";
          const lines = (val.endsWith("\n") ? val.slice(0, -1) : val).split("\n");
          return pad + key + ": " + block + "\n" +
            lines.map((l) => pad + "  " + l).join("\n");
        }
        const leaf = val !== null && typeof val === "object"
          ? (Array.isArray(val) ? "[]" : "{}") : scalar(val);
        return pad + key + ": " + leaf;
      }).join("\n");
    }
    return pad + scalar(v);
  }

  // --------------------------------------------------------------- parse
  function parseScalar(tok) {
    tok = tok.trim();
    if (tok === "" || tok === "~" || tok === "null") return null;
    if (tok === "true") return true;
    if (tok === "false") return false;
    if (tok === "[]") return [];
    if (tok === "{}") return {};
    if (tok[0] === '"') return JSON.parse(tok);
    if (tok[0] === "'") return tok.slice(1, -1).replace(/''/g, "'");
    if (tok[0] === "[" || tok[0] === "{") return parseFlow(tok);
    if (/^[+-]?\d+$/.test(tok)) return parseInt(tok, 10);
    if (/^[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$/.test(tok)) return parseFloat(tok);
    return tok;
  }

  function parseFlow(s) {
    // flow [] / {} — normalize bare words to quoted strings, then JSON
    let out = "", inStr = false, esc = false, word = "";
    const flushWord = () => {
      const w = word.trim();
      if (w) {
        const v = parseScalar(w[0] === "[" || w[0] === "{" ? w : w);
        out += typeof v === "string" ? JSON.stringify(v) : JSON.stringify(v);
      }
      word = "";
    };
    for (const c of s) {
      if (inStr) {
        out += c;
        if (esc) esc = false;
        else if (c === "\\") esc = true;
        else if (c === '"') inStr = false;
      } else if (c === '"') { flushWord(); out += c; inStr = true; }
      else if ("[]{},:".includes(c)) { flushWord(); out += c; }
      else word += c;
    }
    flushWord();
    return JSON.parse(out);
  }

  function parse(text) {
    const lines = [];
    for (const raw of text.split("\n")) {
      if (/^\s*(#|$)/.test(raw) || raw.trim() === "---") continue;
      lines.push(raw);
    }
    let pos = 0;

    function indentOf(line) { return line.match(/^ */)[0].length; }

    function parseBlock(minIndent) {
      if (pos >= lines.length) return null;
      const ind = indentOf(lines[pos]);
      if (ind < minIndent) return null;
      if (lines[pos].trim().startsWith("- ") || lines[pos].trim() === "-") {
        return parseSeq(ind);
      }
      return parseMap(ind);
    }

    function literalBlock(parentIndent, keepNewline) {
      const body = [];
      let blockInd = null;
      while (pos < lines.length) {
        const line = lines[pos];
        if (line.trim() === "") { body.push(""); pos++; continue; }
        const ind = indentOf(line);
        if (ind <= parentIndent) break;
        if (blockInd === null) blockInd = ind;
        body.push(line.slice(blockInd));
        pos++;
      }
      while (body.length && body[body.length - 1] === "") body.pop();
      return body.join("\n") + (keepNewline ? "\n" : "");
    }

    function parseMap(ind) {
      const obj = {};
      while (pos < lines.length) {
        const line = lines[pos];
        if (line.trim() === "") { pos++; continue; }
        if (indentOf(line) !== ind) break;
        const t = line.trim();
        // key must be followed by ": " or end-of-line — "nginx:1.2" is a
        // scalar, not a mapping
        const m = t.match(/^("(?:[^"\\]|\\.)*"|[^:]+):(?: (.*))?$/);
        if (!m) throw new Error("bad mapping line: " + t);
        const key = m[1][0] === '"' ? JSON.parse(m[1]) : m[1].trim();
        const rest = (m[2] || "").trim();
        pos++;
        if (rest === "|" || rest === "|-") {
          obj[key] = literalBlock(ind, rest === "|");
        } else if (rest === "") {
          const child = parseBlock(ind + 1);
          obj[key] = child === null ? null : child;
        } else {
          obj[key] = parseScalar(rest);
        }
      }
      return obj;
    }

    function parseSeq(ind) {
      const arr = [];
      while (pos < lines.length) {
        const line = lines[pos];
        if (line.trim() === "") { pos++; continue; }
        if (indentOf(line) !== ind || !(line.trim().startsWith("- ") || line.trim() === "-")) break;
        const rest = line.trim() === "-" ? "" : line.trim().slice(2);
        if (rest === "") {
          pos++;
          arr.push(parseBlock(ind + 1));
        } else if (rest[0] === '"'
                   ? /^"(?:[^"\\]|\\.)*":(?: .*)?$/.test(rest)
                   : (!/^['[{]/.test(rest) && /^[^:]+:(?: .*)?$/.test(rest))) {
          // a quoted token is a map key only when the colon follows the
          // CLOSING quote: `- "a:b": 1` is a map, `- "x: y"` a scalar
          // inline first key of a block map: "- name: x"
          const itemIndent = ind + 2;
          lines[pos] = " ".repeat(itemIndent) + rest;
          arr.push(parseMap(itemIndent));
        } else {
          pos++;
          arr.push(parseScalar(rest));
        }
      }
      return arr;
    }

    const v = parseBlock(0);
    if (pos < lines.length) throw new Error("unparsed content at line: " + lines[pos].trim());
    return v;
  }

  return { dump: (v) => dump(v, 0) + "\n", parse };
})();
